"""Data parallelism: the device mesh, its ranks and their collectives."""

from ode_vio_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    create_mesh,
    launch,
    replicate,
    shard_batch,
)
