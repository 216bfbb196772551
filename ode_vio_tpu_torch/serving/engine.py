"""Multi-session streaming inference engine (counterpart of
``ode_vio_tpu/serving/engine.py``).

Sessions are lanes of one fixed-size batch of ``max_sessions``:

* Each session's hidden state lives in its lane of the carry on the
  device. The carry is a tensor or a dict of tensors, and the pose core
  declares the axis of every leaf that indexes the lanes
  (``model.carry_lane_axis``): 1 for the ode-rnn's ``(L, B, F)``, 0 for
  the cde/rde ``(B, H)`` and for each leaf of their history-mode dict
  (``z0 (B, H)``, ``buf (B, K, D)``, ``cnt (B,)``). Here the port differs
  on purpose from ``ode_vio_tpu/serving/engine.py``, which takes axis 1
  for every leaf of 3 or more dims, the history ring buffer included.
* Idle lanes replay their previous window (or a zero prototype) and
  their carry is restored afterwards, so an idle session never advances.
* A fresh session gets a zeroed lane carry and its clock re-based to 0.
  A session that opens after the engine's first step therefore starts
  from a zero state, for cde/rde z0 = 0 and not ``tanh(initial(obs0))``,
  as in the JAX engine.
* Truncated-solve counts accumulate only for lanes that served a real
  window.
* While a profiler collects, a step is the span ``ode_vio.serve.step``
  holding ``serve.gather`` (the lanes' windows), ``serve.stack`` (the
  batch), the replicas' ``lanes.*`` spans and ``serve.carry`` (the lane
  mask and the poses on the host) (``utils/profiling.py::span``).
* The lanes split over ``devices`` (default: the one ``device``) as
  equal contiguous blocks, one replica of the model per device with its
  own carry (``parallel/lanes.py::split_lanes``), where JAX shards the lane
  axis over a data mesh. Hard fusion's noise is drawn for every lane and
  sliced, so a session's poses do not depend on the split.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.models.common import Carry
from ode_vio_tpu_torch.parallel.lanes import split_lanes
from ode_vio_tpu_torch.training.loop import make_infer_fn
from ode_vio_tpu_torch.utils.profiling import span

Window = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (imgs, imus, ts)


def _leaves(fn: Callable, carry: Carry, *others: Carry) -> Carry:
    """``fn`` on each leaf of ``carry`` (and the same leaf of ``others``)."""
    if isinstance(carry, dict):
        return {k: fn(v, *(o[k] for o in others)) for k, v in carry.items()}
    return fn(carry, *others)


def _first_leaf(carry: Carry) -> torch.Tensor:
    return next(iter(carry.values())) if isinstance(carry, dict) else carry


def _select_lanes(mask: torch.Tensor, new: Carry, old: Carry, axis: int) -> Carry:
    """Lanes with mask=True take ``new``, the others ``old``."""
    def sel(a, b):
        shape = [1] * a.dim()
        shape[axis] = mask.shape[0]
        return torch.where(mask.reshape(shape), a, b)

    return _leaves(sel, new, old)


class StreamingEngine:
    """``step({sid: (imgs, imus, ts)}) -> {sid: poses}`` advances every
    submitted session by one window (imgs ``(S, H, W, 3)`` float32, imus
    ``(10*(S-1)+1, 6)``, ts ``(S,)`` strictly ascending on the session's
    own clock); poses are ``(S-1, 6)`` numpy arrays. Sessions not in the
    dict are untouched. All windows of one call ride one batched forward
    per device; ``max_sessions`` must be a multiple of the devices.
    """

    def __init__(self, model, state_dict=None, max_sessions: int = 8,
                 fold_bn: bool = True, *, device="cuda", devices: Optional[Sequence] = None):
        self.device = resolve_device(device)
        devices = [self.device] if devices is None else list(devices)
        self.N = int(max_sessions)
        if self.N % len(devices):
            raise ValueError(f"max_sessions={self.N} does not split over {len(devices)} devices")
        self._per = self.N // len(devices)
        self._axis = model.carry_lane_axis
        self._infer = split_lanes(make_infer_fn(model, state_dict, fold_bn=fold_bn,
                                                device=devices[0]), devices)
        self._free = list(range(self.N - 1, -1, -1))
        self._open: set = set()
        self._fresh: set = set()
        self._t_off = np.zeros(self.N, np.float64)
        # one carry per device, each over its block of lanes
        self._carry: Optional[List[Carry]] = None
        self._last: Dict[int, Window] = {}
        self._proto: Optional[Window] = None

    # -- session lifecycle -------------------------------------------------
    def open_session(self) -> int:
        if not self._free:
            raise RuntimeError(f"all {self.N} lanes in use")
        lane = self._free.pop()
        self._open.add(lane)
        self._fresh.add(lane)
        if self._carry is not None:
            part, local = divmod(lane, self._per)
            with torch.inference_mode():  # the carry is the engine's own
                _leaves(lambda leaf: leaf.select(self._axis, local).zero_(), self._carry[part])
        return lane

    def close_session(self, sid: int) -> None:
        self._open.discard(sid)
        self._fresh.discard(sid)
        self._last.pop(sid, None)
        self._free.append(sid)

    # -- serving -----------------------------------------------------------
    def _set_proto(self, imgs, imus, ts) -> None:
        self._proto = (np.zeros_like(np.asarray(imgs, np.float32)),
                       np.zeros_like(np.asarray(imus, np.float32)),
                       np.arange(len(ts), dtype=np.float32) * 0.1)

    @staticmethod
    def _put(arrays) -> torch.Tensor:
        return torch.from_numpy(np.stack(arrays, 0))

    def step(self, windows: Dict[int, Window]) -> Dict[int, np.ndarray]:
        if not windows:
            return {}
        for sid in windows:
            if sid not in self._open:
                raise KeyError(f"session {sid} is not open")
        if self._proto is None:
            self._set_proto(*next(iter(windows.values())))
        with span("ode_vio.serve.step"):
            with span("ode_vio.serve.gather"):
                stacked = [self._lane_window(lane, windows) for lane in range(self.N)]
            with span("ode_vio.serve.stack"):
                imgs, imus, ts = (self._put([w[k] for w in stacked]) for k in range(3))
            active = np.array([ln in windows for ln in range(self.N)])
            poses, carry = self._infer(imgs, imus, ts, self._carry, active=active)
            with span("ode_vio.serve.carry"):
                # lanes that did not really start yet stay zeroed
                old = (self._carry if self._carry is not None
                       else [_leaves(torch.zeros_like, c) for c in carry])
                masks = torch.from_numpy(active).split(self._per)
                self._carry = [_select_lanes(m.to(_first_leaf(c).device), c, o, self._axis)
                               for m, c, o in zip(masks, carry, old)]
                poses = poses.numpy()
        return {sid: poses[sid] for sid in windows}

    def _lane_window(self, lane: int, windows: Dict[int, Window]) -> Window:
        """The window ``lane`` runs this step: its submitted one as float32
        on the session's re-based clock, or, for an idle lane, a replay
        (outputs discarded, carry restored)."""
        if lane not in windows:
            return self._last.get(lane, self._proto)
        imgs, imus, ts = windows[lane]
        ts = np.asarray(ts, np.float64)
        if lane in self._fresh:
            # re-base this session's clock to 0 (cold-start semantics)
            self._t_off[lane] = ts[0]
            self._fresh.discard(lane)
        w = (np.asarray(imgs, np.float32), np.asarray(imus, np.float32),
             (ts - self._t_off[lane]).astype(np.float32))
        self._last[lane] = w
        return w

    def warmup(self, proto: Window) -> None:
        """Run the cold-start and the carried forward once on prototype
        lanes shaped like ``proto`` (building the kernels and warming the
        caches) without a trace: the carry stays unset and the counters
        are reset afterwards."""
        self._set_proto(*proto)
        imgs, imus, ts = (self._put([a] * self.N) for a in self._proto)
        inactive = np.zeros(self.N, bool)
        _, carry = self._infer(imgs, imus, ts, None, active=inactive)
        self._infer(imgs, imus, ts, carry, active=inactive)[0].cpu()
        self._infer.reset_incomplete()

    def hidden(self, sid: int) -> Optional[Carry]:
        """A copy of session ``sid``'s lane of the carry (each leaf without
        its lane axis: (L, F) for ode-rnn, (H,) for cde/rde), or None before
        the first step."""
        if self._carry is None:
            return None
        part, local = divmod(sid, self._per)
        return _leaves(lambda leaf: leaf.select(self._axis, local).clone(), self._carry[part])

    def incomplete(self) -> int:
        """Running total of ODE solves truncated by the step budget,
        counting only lanes that served a real window."""
        return self._infer.incomplete()

    def incomplete_by_lane(self):
        """Per-lane truncated-solve totals (None before the first step)."""
        return self._infer.incomplete_by_lane()
