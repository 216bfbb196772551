"""Lanes split over replicas of one infer callable, one per device: the
counterpart of JAX's lanes sharded over a data mesh for eval
(``data/evaluation.py``) and serving (``serving/engine.py``).

The replicas run one after another in this process, so on one card the
split buys no speed: it keeps the lane layout of a run over several cards
and the JAX package's ``--eval_dp``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.utils.profiling import span


def split_lanes(infer: Callable, devices: Sequence) -> Callable:
    """``infer``'s contract (``training/loop.py::make_infer_fn``) over its
    replicas on ``devices``, the counterpart of JAX's lanes sharded over a
    data mesh, here the replicas of one process. A call's lanes (a multiple of the
    replicas) are cut into equal contiguous blocks in order: block r runs
    on ``devices[r]``'s replica with its own carry, its hard-fusion noise
    the block's slice of a draw for every lane. Inputs may lie anywhere;
    poses come back on the CPU in lane order, and the carry is the list of
    the replicas' carries. The replicas count their truncated solves with
    ``infer``'s own (``incomplete()``; ``incomplete_by_lane`` is theirs in
    lane order); ``active`` and ``cold`` masks are cut like the lanes.
    ``img``, ``imu`` and ``ts`` are each a tensor of all the
    lanes, which the call copies block by block to the replicas' devices,
    or a list of the blocks already on them, taken as they lie (the
    serving engine's resident lane batch). While a profiler collects, each
    replica's copy of its block is the span ``ode_vio.lanes.h2d`` and its
    call ``ode_vio.lanes.forward``; the poses' copy to the host is
    ``ode_vio.lanes.readback``.

    ``split.feature_cache(img, imu, lanes)`` binds the serving engine's
    feature cache: per replica, (visual, inertial) over its block of
    ``lanes`` lanes, every row at the features of the one window ``img``,
    ``imu`` (no lane axis) encoded alone on the replica. From then on each
    replica runs the encoders over its ``active`` lanes alone and the pose
    core on its block of the cache (``infer``'s ``features``). It returns
    the cache and the window's features, one pair of each per replica."""
    devices = [resolve_device(d) for d in devices]
    # the first block runs on ``infer`` itself where it lies on its device
    replicas = [infer if r == 0 and d == infer.device else infer.replicate(d)
                for r, d in enumerate(devices)]
    n = len(replicas)
    features = None

    def split(img, imu, ts, carry=None, active=None, cold=None):
        placed = isinstance(img, (list, tuple))
        if placed and len(img) != n:
            raise ValueError(f"{len(img)} blocks of lanes for {n} replicas")
        B = img[0].shape[0] * n if placed else img.shape[0]
        if B % n:
            raise ValueError(f"{B} lanes do not split over {n} replicas")
        per = B // n
        poses, carries = [], []
        for r, rep in enumerate(replicas):
            rows = slice(r * per, (r + 1) * per)
            if placed:
                xs = [x[r] for x in (img, imu, ts)]
            else:
                with span("ode_vio.lanes.h2d"):
                    xs = [x[rows].to(rep.device) for x in (img, imu, ts)]
            with span("ode_vio.lanes.forward"):
                p, c = rep(*xs, None if carry is None else carry[r],
                           None if active is None else np.asarray(active)[rows],
                           lanes=(r * per, B),
                           cold=None if cold is None else np.asarray(cold)[rows],
                           features=None if features is None else features[r])
            poses.append(p)
            carries.append(c)
        with span("ode_vio.lanes.readback"):
            return torch.cat([p.cpu() for p in poses]), carries

    def incomplete_by_lane():
        lanes = [rep.incomplete_by_lane() for rep in replicas]
        return None if any(x is None for x in lanes) else np.concatenate(lanes)

    def set_variables(sd: Dict[str, torch.Tensor]) -> None:
        for rep in replicas:
            rep.set_variables(sd)

    def feature_cache(img, imu, lanes: int):
        nonlocal features
        one = [tuple(f[0] for f in rep.encode(img[None], imu[None])) for rep in replicas]
        features = [tuple(f.expand(lanes, *f.shape).clone() for f in fs) for fs in one]
        return features, one

    split.incomplete = infer.incomplete
    split.incomplete_by_lane = incomplete_by_lane
    split.reset_incomplete = infer.reset_incomplete
    split.set_variables = set_variables
    split.feature_cache = feature_cache
    split.device = None
    return split
