"""The device mesh of data-parallel training, and the ranks behind it
(counterpart of ``ode_vio_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``(data, model)`` grid and lets XLA
partition one program over it. Here every device is a process of a
``torch.distributed`` process group, a rank, and the grid is the ranks':
rank ``r`` sits at ``(r // model, r % model)``, as JAX reshapes its device
list. :func:`create_mesh` builds one process group per row and per column
of the grid, so a collective runs over one axis:

  * axis ``data``: each rank takes its data coordinate's rows of a global
    batch (:func:`batch_rows`), BatchNorm statistics and the gradient are
    summed over the data group (``models/encoders.py``,
    ``training/loop.py``);
  * axis ``model``: ranks that share a data coordinate take the same rows
    and compute the same step, as JAX's ``P("data")`` replicates the
    batch over ``model``. :func:`param_sharding_rules` says which weights
    JAX would split over it; the train step keeps them replicated, as the
    JAX command line does.

A world of one process has no process group and calls no collective.
Ranks are started by :func:`launch` (one process per device of this
host, its rendezvous a file store) or, with ``--multihost``, by a job
launcher such as ``torchrun`` (:func:`init_multihost` reads its
variables). Every address and rank is given explicitly. The backend is
``nccl`` where each rank of a host has a card of its own, else ``gloo``
(the CPU, or ranks that share a card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# a collective that waits longer than this fails the rank, and the run
COLLECTIVE_TIMEOUT_S = 600.0
# (variable, its SLURM counterpart) that --multihost reads
MULTIHOST_ENV = (("MASTER_ADDR", None), ("MASTER_PORT", None), ("RANK", "SLURM_PROCID"),
                 ("WORLD_SIZE", "SLURM_NTASKS"), ("LOCAL_RANK", "SLURM_LOCALID"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` grid of ranks. ``shape`` and ``coords`` are
    dicts keyed by the axis names (the grid's size along each axis, this
    rank's place on it); ``groups`` holds, per axis, the process group of
    the ranks that differ from this one along that axis only (None where
    the axis has size 1)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def world_size() -> int:
    """The ranks of the process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of ``data * model`` ranks. ``devices``, one per rank,
    default the process group's ranks; ``data`` -1 takes what ``model``
    leaves. ValueError where ``data * model`` does not match them (JAX's
    error), or where they are not the process group's ranks."""
    n = len(devices) if devices is not None else world_size()
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not match {n} devices")
    if n != world_size():
        raise ValueError(f"a mesh of {n} devices needs as many ranks, and the process group "
                         f"has {world_size()}: start one rank per device (launch, or "
                         "--multihost under a job launcher)")
    rank = dist.get_rank() if n > 1 else 0
    coords = {"data": rank // model, "model": rank % model}
    groups: Dict[str, Any] = {"data": None, "model": None}
    if n > 1:
        # every rank creates every group, in the same order
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == coords["model"] and data > 1:
                groups["data"] = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == coords["data"] and model > 1:
                groups["model"] = g
    return Mesh({"data": data, "model": model}, coords, groups)


def auto_data_axis(batch_size: int, model: int = 1,
                   devices: Optional[Sequence] = None) -> int:
    """Largest data-parallel axis that evenly divides both the batch and
    the device count (a 4-sample debug batch on an 8-device host should
    use 4 devices, not crash). ``devices`` default this host's cards."""
    n = (len(devices) if devices is not None else max(torch.cuda.device_count(), 1)) // model
    return max(k for k in range(1, n + 1) if batch_size % k == 0 and n % k == 0)


def local_devices(count: int, device) -> List[torch.device]:
    """The first ``count`` devices of ``device``'s type on this host: the
    cards ``cuda:0..count-1`` (-1: every card; ValueError for more than
    there are), or ``count`` times the CPU, which ranks and replicas share
    (-1: one)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * max(count, 1)
    n = torch.cuda.device_count()
    count = n if count == -1 else count
    if count > n:
        raise ValueError(f"{count} devices asked for and this host has {n} CUDA cards")
    return [torch.device("cuda", i) for i in range(count)]


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch: the ``shape["data"]`` equal
    contiguous blocks in order, by its data coordinate (JAX's
    ``P("data")``); ranks that share a data coordinate take the same
    rows."""
    data = mesh.shape["data"]
    if batch_size % data:
        raise ValueError(f"batch {batch_size} does not split over a data axis of {data}")
    per = batch_size // data
    i = mesh.coords["data"]
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of each array of ``batch`` (the leading axis)."""
    rows = batch_rows(mesh, len(batch[0]))
    return tuple(x[rows] for x in batch)


class _AllSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents over it, so
    each rank's gradient holds every rank's use of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable; ``x``
    itself where there is no group."""
    return x if group is None else _AllSum.apply(x, group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``, differentiable."""
    return x if group is None else _AllSum.apply(x, group) / dist.get_world_size(group)


def replicate(state, mesh: Mesh):
    """Rank 0's train state on every rank, in place (JAX's
    ``replicated``): the model's parameters and buffers, the optimizer's
    state, the step and the generator's state are broadcast from rank 0."""
    if mesh.size == 1:
        return state
    tensors = [*state.model.parameters(), *state.model.buffers()]
    opt = state.optimizer
    for st in opt.inner.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    tensors += opt._mean or []
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    gen = state.generator.get_state()
    dist.broadcast(gen, src=0)
    state.generator.set_state(gen)
    step = torch.tensor([state.step, opt.mini_step], dtype=torch.int64)
    dist.broadcast(step, src=0)
    state.step, opt.mini_step = (int(v) for v in step)
    return state


def is_rank0() -> bool:
    """Whether this process is rank 0 of its process group (or has none)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def param_sharding_rules(model: nn.Module, mesh: Mesh, min_size: int = 2 ** 16
                         ) -> Dict[str, Optional[int]]:
    """For each parameter of ``model``, the axis JAX's heuristic would
    split over ``model`` (None: replicated). JAX splits the trailing axis
    of a 2-D kernel of at least ``min_size`` elements where the model axis
    divides it. A flax ``Dense`` kernel is ``(in, out)`` in JAX and its
    ``nn.Linear.weight`` ``(out, in)`` here, so its axis is 0; the MLP
    fields', the liquid cells' and the RNN weights have one layout in
    both (models/convert.py), so theirs is the last."""
    from ode_vio_tpu_torch.models.common import MLPField
    from ode_vio_tpu_torch.ops.liquid import CfCCell, LTCCell

    tp = mesh.shape["model"]
    same_layout = {f"{name}.{p}" for name, m in model.named_modules()
                   if isinstance(m, (MLPField, CfCCell, LTCCell))
                   for p, _ in m.named_parameters()}
    dense = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, nn.Linear)} - same_layout
    rules = {}
    for name, p in model.named_parameters():
        axis = 0 if name in dense else p.dim() - 1
        split = (tp > 1 and p.dim() == 2 and p.numel() >= min_size
                 and p.shape[axis] % tp == 0)
        rules[name] = axis if split else None
    return rules


# -- ranks ------------------------------------------------------------------

def backend_for(devices: Sequence[torch.device]) -> str:
    """``nccl`` where every rank has a card of its own, else ``gloo``."""
    devices = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devices)
                 and len({d.index for d in devices}) == len(devices))
    return "nccl" if own_cards else "gloo"


def _init_group(backend: str, init_method: str, rank: int, world: int, device: torch.device
                ) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _rank_main(fn, rank: int, devices, backend: str, init_method: str, threads: int,
               results, args) -> None:
    """One rank of :func:`launch`: join the group, run ``fn(device,
    *args)`` and put ``(rank, ok, pickled result or traceback)`` on
    ``results``. The result goes as plain pickle bytes: a tensor put on a
    queue as it is travels as a handle to this process's shared memory,
    which ends with the rank."""
    device = devices[rank]
    if device.type == "cpu":
        torch.set_num_threads(threads)
    try:
        _init_group(backend, init_method, rank, len(devices), device)
        try:
            out = (rank, True, pickle.dumps(fn(device, *args)))
        finally:
            dist.destroy_process_group()
    except (Exception, SystemExit):
        out = (rank, False, traceback.format_exc())
    results.put(out)


def launch(fn: Callable, devices: Sequence, *args, backend: Optional[str] = None) -> list:
    """Run ``fn(device, *args)`` in one process per entry of ``devices``
    on this host, rank r on ``devices[r]``, joined in one process group
    (``backend``, default :func:`backend_for`); return each rank's result,
    in rank order. ``fn`` and its arguments are pickled (``fn`` by its
    import path; a module that imports nothing heavy keeps the ranks'
    start short). The rendezvous is a file store in a fresh temporary
    directory. A rank that raises or dies ends every other rank, and
    launch raises RuntimeError with its traceback."""
    import multiprocessing as mp
    import queue

    devices = [torch.device(d) for d in devices]
    backend = backend or backend_for(devices)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="mesh-")
    init_method = "file://" + os.path.join(store, "rendezvous")
    threads = max(1, torch.get_num_threads() // len(devices))
    procs = [ctx.Process(target=_rank_main, args=(fn, r, devices, backend, init_method,
                                                  threads, results, args))
             for r in range(len(devices))]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < len(procs):
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {len(procs)} exited with code "
                                       f"{procs[dead[0]].exitcode} before it reported")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(store, ignore_errors=True)
    return [out[r] for r in range(len(procs))]


def init_multihost(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the job's process group as one rank (the counterpart of
    ``jax.distributed.initialize()``), from the variables a launcher sets:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (torchrun's names; SLURM's ``SLURM_PROCID``,
    ``SLURM_NTASKS`` and ``SLURM_LOCALID`` stand in for the last three).
    SystemExit naming the variables that are missing. Returns this rank's
    device: the card ``LOCAL_RANK``, or the CPU. The backend defaults to
    ``nccl`` where the host's ranks (``LOCAL_WORLD_SIZE``, else one per
    card) each have a card."""
    env = {}
    for name, alt in MULTIHOST_ENV:
        value = os.environ.get(name) or (os.environ.get(alt) if alt else None)
        if value is not None:
            env[name] = value
    missing = [name + (f" (or {alt})" if alt else "") for name, alt in MULTIHOST_ENV
               if name not in env]
    if missing:
        raise SystemExit("--multihost needs the launcher's variables; missing: "
                         + ", ".join(missing))
    rank, world, local = (int(env[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local)
    if backend is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", torch.cuda.device_count() or 1))
        backend = ("nccl" if device.type == "cuda" and per_host <= torch.cuda.device_count()
                   else "gloo")
    _init_group(backend, f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", rank, world,
                device)
    return device
