"""The repository's two top-level entry points on the port (counterparts of
``__graft_entry__.py``'s):

* :func:`entry` -- the flagship DeepVIO forward (PoseODERNN at the
  reference dimensions, seed-0 weights) and its batch-1 example, on the
  card, its ode-rnn solves through kernel K1;
* :func:`dryrun_multichip` -- the full training step over an
  ``n_devices`` ``(data, model)`` mesh of ranks, the large weights split
  over ``model``, for one cycle of gradient accumulation (two steps) on
  tiny shapes.

From the repository's root::

    python -c "from ode_vio_tpu_torch.entry import entry; fn, a = entry(); print(fn(*a).shape)"
    python -c "from ode_vio_tpu_torch.entry import dryrun_multichip; dryrun_multichip(4)"

Both default to CUDA (``device="cpu"`` runs them on the CPU, the kernels'
plain versions in place of the kernels). ``dryrun_multichip`` starts one
rank per device (``parallel/mesh.py::launch``): a card each where the host
has enough, else ranks sharing ``cuda:0`` over gloo, or gloo ranks on the
CPU.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ode_vio_tpu_torch.config import (Config, DataConfig, ModelConfig, SolverConfig,
                                      TrainConfig, flagship_config, resolve_device)
from ode_vio_tpu_torch.models.deepvio import create_model
from ode_vio_tpu_torch.ops import cuda_kernels
from ode_vio_tpu_torch.parallel.mesh import (create_mesh, launch, local_devices, model_split,
                                             shard_batch)
from ode_vio_tpu_torch.training.loop import TrainState, create_train_state, make_train_step

KERNELS = ("fused_ode_solve", "fused_cde_solve", "fused_dropout")


def example_batch(cfg: Config, batch_size: int, device="cpu") -> Tuple[torch.Tensor, ...]:
    """``(img, imu, ts)``: JAX's ``_example_batch``, the same draws from
    ``numpy.random.default_rng(0)`` in the same order, as float32 tensors
    on ``device``."""
    m = cfg.model
    S = m.seq_len
    rng = np.random.default_rng(0)
    img = rng.random((batch_size, S, m.img_h, m.img_w, 3), np.float32) - 0.5
    imu = rng.standard_normal((batch_size, 10 * (S - 1) + 1, 6)).astype(np.float32)
    ts = np.cumsum(rng.random((batch_size, S)).astype(np.float32) * 0.05 + 0.08, axis=1)
    return tuple(torch.from_numpy(x).to(device) for x in (img, imu, ts))


def build_forward(cfg: Config, *, device="cuda"):
    """``(fn, example_args)`` for ``cfg``'s model on ``device``: ``fn(img,
    imu, ts)`` returns the poses (B, S-1, 6) of its eval-mode forward from
    the seed-0 init; hard fusion's noise comes from a generator seeded with
    0 on every call, as JAX applies ``PRNGKey(0)``. ``example_args`` is the
    batch-1 example of :func:`example_batch` on ``device``. Where
    ``use_kernels`` resolves on (auto: on CUDA) the solves go through the
    port's kernels, and a kernel that does not build or launch raises.
    ``fn.model`` is the model (``fn.model.load_state_dict`` loads other
    weights)."""
    device = resolve_device(device)
    model = create_model(cfg, seed=0, device=device)
    hard = cfg.model.fuse_method == "hard"

    @torch.inference_mode()
    def fn(img, imu, ts):
        gen = torch.Generator(device).manual_seed(0) if hard else None
        return model(img, imu, ts, generator=gen)[0]

    fn.model = model
    return fn, example_batch(cfg, 1, device)


def entry(device="cuda"):
    """``(fn, example_args)``: the flagship PoseODERNN forward at reference
    scale (256x512 images, seq_len 11, 768-d fused features, adaptive
    dopri5; ``config.flagship_config()``, seed-0 weights) and its batch-1
    example, on ``device``."""
    return build_forward(flagship_config(), device=device)


# -- dryrun_multichip ---------------------------------------------------------

def dryrun_config(n_devices: int) -> Tuple[Config, Tuple[int, int]]:
    """JAX's dryrun configuration and mesh shape ``(data, model)`` for
    ``n_devices``: the model axis 2 where ``n_devices`` is even and at
    least 4, a global batch of 2 rows a data coordinate, and one cycle of
    two-step gradient accumulation."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // tp
    cfg = Config(
        model=ModelConfig(model_type="ode-rnn", img_w=128, img_h=64, seq_len=3,
                          v_f_len=128, i_f_len=64, ode_hidden_dim=128, rnn_num_layers=2,
                          fuse_method="soft", compute_dtype="float32"),
        solver=SolverConfig(max_steps=8, dt0=1e-2),
        train=TrainConfig(batch_size=2 * dp, grad_accumulation_steps=2),
        data=DataConfig(seq_len=3),
    )
    return cfg, (dp, tp)


def dryrun_batch(cfg: Config, device="cpu") -> Tuple[torch.Tensor, ...]:
    """The dryrun's global batch ``(img, imu, gts, ts)``, JAX's draws."""
    B = cfg.train.batch_size
    img, imu, ts = example_batch(cfg, B, device)
    gts = np.random.default_rng(1).standard_normal((B, cfg.model.seq_len - 1, 6)) * 0.1
    return img, imu, torch.from_numpy(gts.astype(np.float32)).to(device), ts


def stored_bytes(state: TrainState) -> Dict[str, int]:
    """The bytes this rank stores for its parameters and its optimizer
    state (moments, accumulation mean), those of split parameters apart,
    and what a rank that keeps every parameter whole stores."""
    opt = state.optimizer
    split = model_split(state.model)
    parts = 1 if split is None else split.parts
    axes = {id(p): a for p, a in zip(opt.params, opt.axes)}

    def nbytes(t) -> int:
        return t.numel() * t.element_size() if torch.is_tensor(t) and t.dim() else 0

    def is_split(p) -> bool:
        return split is not None and split.axis_of(p) is not None

    params = [(nbytes(p), is_split(p)) for p in state.model.parameters()]
    moments = [(nbytes(v), axes.get(id(p)) is not None)
               for p, st in opt.inner.state.items() for v in st.values()]
    moments += [(nbytes(m), a is not None) for m, a in zip(opt._mean or [], opt.axes)]
    out = {}
    for name, rows in (("params", params), ("optimizer", moments)):
        total, of_split = sum(b for b, _ in rows), sum(b for b, s in rows if s)
        out[name] = total
        out[f"{name}_split"] = of_split
        out[f"{name}_unsplit"] = total + (parts - 1) * of_split
    return out


def dryrun_steps(device, cfg: Config, shape: Tuple[int, int]) -> dict:
    """One rank of the dryrun (or, for a mesh of one, all of it in this
    process): ``cfg``'s train state from the seed-0 init over a ``shape =
    (data, model)`` mesh with the parameters split over ``model``
    (``create_train_state(..., split_params=True)``), and two train steps
    on this rank's rows of :func:`dryrun_batch`. Returns its mesh coordinates, each step's
    metrics, :func:`stored_bytes`, the parameter shapes it holds, the
    kernels' launches in this process, and, from rank 0, the trained
    tensors (the optimizer's parameters and the BatchNorm statistics),
    gathered whole."""
    device = torch.device(device)
    mesh = create_mesh(*shape)
    model = create_model(cfg, seed=0, device=device, train=True)
    state = create_train_state(cfg, model, seed=1, device=device, mesh=mesh, split_params=True)
    step = make_train_step(cfg, device=device, mesh=mesh)
    batch = shard_batch(mesh, dryrun_batch(cfg, device))
    metrics = []
    for _ in range(2):  # the second completes the accumulation cycle and updates
        state, m = step(state, *batch)
        metrics.append({k: float(v) for k, v in m.items()})
    trained = {id(p) for p in state.optimizer.params}
    names = {n for n, p in state.model.named_parameters() if id(p) in trained}
    whole = state.model.state_dict()  # a collective where parameters are split
    rank = torch.distributed.get_rank() if mesh.size > 1 else 0
    return {"rank": rank, "coords": mesh.coords, "metrics": metrics,
            "stored_bytes": stored_bytes(state),
            "shapes": {n: tuple(p.shape) for n, p in state.model.named_parameters()},
            "launches": {k: getattr(cuda_kernels, k).launches for k in KERNELS},
            "state": None if rank else {k: v.detach().cpu() for k, v in whole.items()
                                        if k in names or "running" in k}}


def dryrun_devices(n_devices: int, device) -> list:
    """One device a rank: a card each where this host has ``n_devices``,
    else ``cuda:0`` shared by every rank; on the CPU, the CPU each."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        return [torch.device("cuda", 0)] * n_devices
    return local_devices(n_devices, device)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run JAX's dryrun on the port: ``n_devices`` ranks (one process each,
    :func:`dryrun_devices`) on a ``(data, model)`` mesh, each storing its
    slice of the weights ``param_sharding_rules`` splits over ``model``,
    take two train steps (one cycle of ``grad_accumulation_steps=2``) on
    the tiny configuration of :func:`dryrun_config`. Prints each rank's
    stored bytes beside an unsplit rank's as one JSON line, then JAX's
    ``dryrun_multichip ok: mesh={'data': .., 'model': ..} loss=...`` with
    the last step's loss; returns every rank's :func:`dryrun_steps`.
    RuntimeError where a rank fails or the loss is not finite."""
    cfg, shape = dryrun_config(n_devices)
    ranks = launch(dryrun_steps, dryrun_devices(n_devices, device), cfg, shape)
    print(json.dumps({"dryrun_multichip_stored_bytes": [
        {"rank": r["rank"], "coords": r["coords"], **r["stored_bytes"]} for r in ranks]}),
        flush=True)
    loss = ranks[0]["metrics"][-1]["loss"]
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")
    print(f"dryrun_multichip ok: mesh={dict(zip(('data', 'model'), shape))} loss={loss:.4f}",
          flush=True)
    return ranks
