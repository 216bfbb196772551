"""Streaming-eval inference callable (counterpart of
``ode_vio_tpu/training/loop.py::make_infer_fn``). The training half of
the JAX module is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.fold import fold_batchnorm_into_bias


def make_infer_fn(model: DeepVIO, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  fold_bn: bool = False, *, device="cuda") -> Callable:
    """Build ``infer(img, imu, ts, carry=None, active=None) -> (poses,
    carry)`` on ``device``: the cold-start call without a carry, the
    carried call with one.

    The callable holds its own copy of the model, loaded from
    ``state_dict`` (default: ``model.state_dict()``). ``fold_bn=True``
    folds the BatchNorm statistics into the conv weights and biases
    (models/fold.py) and builds that copy with ``skip_bn=True``, so no
    BatchNorm runs. ``infer.set_variables(state_dict)`` swaps the weights.

    Truncated solves are counted on the device per batch lane:
    ``infer.incomplete()`` is the running total and
    ``infer.incomplete_by_lane()`` the per-lane vector. ``active``, a
    boolean lane mask, keeps lanes that serve no real window out of the
    counts. Hard fusion draws its Gumbel noise from a generator seeded
    with 0 on every call, as the JAX callable applies ``PRNGKey(0)``.
    """
    device = resolve_device(device)
    cfg = model.cfg
    strip_bn = fold_bn and not cfg.skip_bn
    if strip_bn:
        cfg = dataclasses.replace(cfg, skip_bn=True)
    with torch.device("meta"):
        net = DeepVIO(cfg, model.solver, model.cde_solver)
    net = net.to_empty(device=device).eval()

    def set_variables(sd: Dict[str, torch.Tensor]) -> None:
        net.load_state_dict(fold_batchnorm_into_bias(sd) if strip_bn else sd,
                            strict=True)

    set_variables(model.state_dict() if state_dict is None else state_dict)
    hard = cfg.fuse_method == "hard"

    @torch.inference_mode()
    def infer(img, imu, ts, carry=None, active=None):
        gen = torch.Generator(device).manual_seed(0) if hard else None
        poses, carry, stats = net(img, imu, ts, carry, generator=gen)
        inc = stats.incomplete
        if active is not None:
            inc = inc * torch.as_tensor(np.asarray(active), device=device).to(inc.dtype)
        infer._inc_total += inc.sum()
        if infer._inc_lanes is None or infer._inc_lanes.shape != inc.shape:
            infer._inc_lanes = inc.clone()  # lane layout changed: restart
        else:
            infer._inc_lanes += inc
        return poses, carry

    def reset_incomplete() -> None:
        infer._inc_total = torch.zeros((), dtype=torch.int64, device=device)
        infer._inc_lanes = None

    reset_incomplete()
    infer.incomplete = lambda: int(infer._inc_total)
    infer.incomplete_by_lane = lambda: (
        None if infer._inc_lanes is None else infer._inc_lanes.cpu().numpy())
    infer.reset_incomplete = reset_incomplete
    infer.set_variables = set_variables
    return infer
