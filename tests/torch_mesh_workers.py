"""The ranks' side of tests/test_torch_port_mesh.py, in a module that
imports no JAX: ``parallel/mesh.py::launch`` starts each rank by
importing the module of its function, and a rank has no use for JAX.

:func:`rank_cases` runs every case of one world of ranks on the CPU and
returns what the tests hold against JAX and the one-process port: per
case each step's metrics, a digest of the whole state (model, optimizer,
step, generator) to compare the ranks bit for bit, and from rank 0 the
trained tensors and each step's (global) gradients."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ode_vio_tpu_torch.models.common import RankKeys, draw_key
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.encoders import ImageEncoder, share_batch_statistics
from ode_vio_tpu_torch.parallel.mesh import create_mesh, shard_batch
from ode_vio_tpu_torch.training import loop as tloop
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager

METRICS = ("loss", "angle_loss", "trans_loss", "grad_norm", "solver_incomplete")


def port_state(case: dict, sd: dict, device, mesh=None, split_params=False):
    """The case's model from the state dict ``sd`` (the image trunk of
    ``case["trunk"]`` where given) as a train state on ``device``, its
    parameters split over the mesh's model axis with ``split_params``."""
    cfg = case["cfg"]
    model = DeepVIO(cfg.model, cfg.solver, cfg.cde_solver_cfg)
    if case.get("trunk") is not None:
        model.Image_net = ImageEncoder(cfg.model, case["trunk"])
    model.load_state_dict(sd, strict=True)
    return tloop.create_train_state(cfg, model, device=device, mesh=mesh,
                                    split_params=split_params)


def record_grads(state) -> list:
    """Each optimizer step's gradients by parameter name, as the
    optimizer sees them."""
    opt, seen, step = state.optimizer, [], state.optimizer.step
    names = {id(p): n for n, p in state.model.named_parameters()}

    def record(grads):
        seen.append({names[id(p)]: g.detach().clone() for p, g in zip(opt.params, grads)})
        step(grads)

    opt.step = record
    return seen


def run_steps(case: dict, state, device, mesh=None) -> list:
    """The case's steps on ``state`` (this rank's rows of each batch under
    ``mesh``); each step's metrics as floats."""
    cfg, kind = case["cfg"], case["kind"]
    if kind == "stream":
        step = tloop.make_streaming_train_step(cfg, device=device, mesh=mesh)
    else:
        step = tloop.make_train_step(cfg, carry=kind == "carry", device=device, mesh=mesh)
    hc, out = None, []
    for batch in case["batches"]:
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        if kind == "stream":
            state, m, hc = step(state, *batch, hc)
        else:
            state, m = step(state, *batch)
        out.append({k: float(m[k]) for k in METRICS})
    return out


def digest(state) -> str:
    """SHA-256 of everything a checkpoint holds, in a fixed order."""
    h = hashlib.sha256()
    tensors = list(state.model.state_dict().values())
    for st in state.optimizer.inner.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    tensors += state.optimizer._mean or []
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    h.update(state.generator.get_state().numpy().tobytes())
    h.update(np.int64([state.step, state.optimizer.mini_step]).tobytes())
    return h.hexdigest()


def trained(state, grads: list) -> dict:
    """The tensors a step moves (trained parameters and every BatchNorm
    statistic), and the recorded gradients, as numpy."""
    names = set(grads[0]) if grads else set()
    sd = state.model.state_dict()
    return {"state": {k: v.numpy() for k, v in sd.items()
                      if k in names or "running" in k},
            "grads": [{k: g.numpy() for k, g in step.items()} for step in grads]}


def rank_cases(device, sd: dict, cases: dict, bn_case: dict) -> dict:
    """Every case in one world of ranks (``parallel/mesh.py::launch``).
    ``cases`` maps a name to ``cfg``, ``kind`` (fresh, carry or stream),
    ``batches`` (global), ``mesh`` ((data, model)) and optionally
    ``trunk`` and ``keys`` (also return the first key each rank mixes).
    ``bn_case`` holds a train-mode encoders' forward: its config and
    global inputs; the rank returns its rows' features and the running
    statistics."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    out = {}
    for name, case in cases.items():
        mesh = create_mesh(*case["mesh"])
        state = port_state(case, sd, device, mesh)
        grads = record_grads(state)
        res = {"rows": mesh.coords["data"]}
        if case.get("keys"):
            gen = torch.Generator().manual_seed(0)
            gen.set_state(state.generator.get_state())
            res["key"] = draw_key(RankKeys(gen, mesh.coords["data"]))
        res["metrics"] = run_steps(case, state, device, mesh)
        res["digest"] = digest(state)
        if rank == 0:
            res.update(trained(state, grads))
        out[name] = res
    mesh = create_mesh(-1, 1)
    cfg = bn_case["cfg"]
    model = DeepVIO(cfg.model)
    model.Image_net = ImageEncoder(cfg.model, bn_case["trunk"])
    model.load_state_dict(sd, strict=True)
    model.train()
    share_batch_statistics(model, mesh.groups["data"])
    img, imu = shard_batch(mesh, bn_case["inputs"])
    with torch.no_grad():
        fv, fi = model.encode(torch.as_tensor(img), torch.as_tensor(imu),
                              torch.Generator().manual_seed(0))
    out["bn"] = {"fv": fv.numpy(), "fi": fi.numpy(),
                 "stats": {k: v.numpy() for k, v in model.state_dict().items()
                           if "running" in k}}
    return out


def whole_digest(state) -> str:
    """SHA-256 of the state as a checkpoint holds it (its state dicts: a
    split model's and optimizer's whole tensors, gathered; every rank
    calls it)."""
    h = hashlib.sha256()
    opt = state.optimizer.state_dict()
    tensors = list(state.model.state_dict().values())
    for _, st in sorted(opt["inner"]["state"].items()):
        tensors += [v for _, v in sorted(st.items())]
    tensors += opt["mean"] or []
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    h.update(state.generator.get_state().numpy().tobytes())
    h.update(np.int64([state.step, state.optimizer.mini_step]).tobytes())
    return h.hexdigest()


def rank_split(device, sd: dict, case: dict, ckpt_dir) -> dict:
    """One rank of a world whose mesh (``case["mesh"]``) has a model axis:
    the case with the parameters split over it
    (``create_train_state(split_params=True)``). Returns each step's
    metrics, the digest of the state as a checkpoint holds it (and of a
    fresh split state restored from the checkpoint the ranks save under
    ``ckpt_dir``), the shapes this rank stores (parameters and optimizer
    state) and its slices of the split parameters; rank 0 adds the gathered ``state_dict()``, the gathered
    optimizer moments, the trained tensors and each step's gradients (its
    slices) by name."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    mesh = create_mesh(*case["mesh"])
    state = port_state(case, sd, device, mesh, split_params=True)
    grads = record_grads(state)
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    res = {"coords": mesh.coords, "metrics": run_steps(case, state, device, mesh),
           "shapes": {n: tuple(p.shape) for n, p in state.model.named_parameters()},
           "axes": {names[id(p)]: a for p, a in zip(opt.params, opt.axes)},
           "moment_shapes": {names[id(p)]: {k: tuple(v.shape) for k, v in st.items()}
                             for p, st in opt.inner.state.items()},
           "slices": {names[id(p)]: p.detach().numpy().copy()
                      for p, a in zip(opt.params, opt.axes) if a is not None},
           "digest": whole_digest(state)}
    manager = CheckpointManager(ckpt_dir)
    manager.save("split", state)
    fresh = port_state(case, sd, device, mesh, split_params=True)
    res["restored_digest"] = whole_digest(manager.restore("split", fresh))
    # gathered: every rank takes part
    whole = state.model.state_dict()
    moments = opt.state_dict()["inner"]["state"]
    if rank == 0:
        kept = set(grads[0])
        res["state"] = {k: v.numpy() for k, v in whole.items() if k in kept or "running" in k}
        res["grads"] = [{k: g.numpy() for k, g in step.items()} for step in grads]
        res["state_dict"] = {k: v.numpy() for k, v in whole.items()}
        res["moments"] = [{k: v.numpy() for k, v in moments[i].items()}
                          for i in range(len(opt.params))]
    return res
