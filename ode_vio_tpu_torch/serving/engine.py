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
* The lane batch stays on the device: one block of lanes per replica,
  allocated once (by ``warmup`` or the first step) and filled with the
  prototype window (zero images and IMU, ts 0, 0.1, ...). A step copies
  only the submitted windows into it, each into its lane's pinned host
  slot and from there to the lane's device slot without blocking (on a
  CPU device straight into the lane's slot). An idle lane's slot holds
  what the lane replays: its last window, or the prototype before its
  first window, after ``close_session`` and after ``warmup``. A window
  shaped unlike the slots is refused.
* Beside the lane batch each block keeps a feature cache of its lanes:
  the visual and inertial features of the window each slot holds, in the
  encoders' float32 (the prototype's, computed once, where a slot holds
  the prototype). A step runs the encoders only over the submitted lanes,
  gathered on the device and padded with the first of them to the next
  power of two at most the block's lanes (``training/loop.py::
  encoder_bucket``; ``warmup`` runs every such batch once, so no step
  builds a new plan), writes their features into the cache and runs the
  pose core on the whole cache. So the pose core still steps every lane,
  in lane order; an idle lane replays its slot's window from its cached
  features and its carry is restored afterwards, so an idle session never
  advances. Here the port differs on purpose from the JAX engine, whose
  forward encodes every lane each step.
* A fresh session gets a zeroed lane carry and its clock re-based to 0.
  Its first window starts cold, as the model does without a carry: for
  ode-rnn, rnn, cfc and ltc that is the zeroed carry itself; for cde/rde
  (``DeepVIO.cold_mask``) a step that serves sessions' first windows
  beside carried lanes passes those lanes as a ``cold`` mask, so they
  start from ``tanh(initial(obs0))`` (history mode: a fresh buffer and
  count) and not from z0 = 0, unlike the JAX engine, whose sessions that
  open after its first step start from zeros.
* Truncated-solve counts accumulate only for lanes that served a real
  window.
* While a profiler collects, a step is the span ``ode_vio.serve.step``
  holding ``serve.gather`` (the submitted windows as float32 on their
  re-based clocks), ``serve.stack`` (their copies into the host slots),
  ``lanes.h2d`` (the copies to the device slots), the replicas'
  ``lanes.*`` spans and ``serve.carry`` (the lane mask and the poses on
  the host), and counts the lanes copied as
  ``ode_vio.serve.lanes_staged`` (``utils/profiling.py::span``,
  ``count``); each replica counts the rows its encoders ran, padding
  included, as ``ode_vio.serve.lanes_encoded``.
* The lanes split over ``devices`` (default: the one ``device``) as
  equal contiguous blocks, one replica of the model per device with its
  own carry and its own block of the lane batch and of the feature cache
  (``parallel/lanes.py::split_lanes``), where JAX shards the lane axis
  over a data mesh. Hard fusion's noise is drawn for every lane and
  sliced, so a session's poses do not depend on the split.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.models.common import Carry
from ode_vio_tpu_torch.parallel.lanes import split_lanes
from ode_vio_tpu_torch.training.loop import encoder_bucket, make_infer_fn
from ode_vio_tpu_torch.utils.profiling import count, span

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
        self._devices = [self.device] if devices is None else [resolve_device(d) for d in devices]
        self.N = int(max_sessions)
        if self.N % len(self._devices):
            raise ValueError(f"max_sessions={self.N} does not split over "
                             f"{len(self._devices)} devices")
        self._per = self.N // len(self._devices)
        self._axis = model.carry_lane_axis
        self._cold_mask = model.cold_mask
        self._infer = split_lanes(make_infer_fn(model, state_dict, fold_bn=fold_bn,
                                                device=self._devices[0]), self._devices)
        self._free = list(range(self.N - 1, -1, -1))
        self._open: set = set()
        self._fresh: set = set()
        self._t_off = np.zeros(self.N, np.float64)
        # one carry per device, each over its block of lanes
        self._carry: Optional[List[Carry]] = None
        self._proto: Optional[Window] = None
        # the lane batch: per field (imgs, imus, ts) one block per device;
        # per block its pinned host slots and, per lane, an event recorded
        # after the last copy out of the lane's pinned slot (None on a CPU)
        self._batch: Optional[Tuple[List[torch.Tensor], ...]] = None
        self._pinned: List[Optional[Tuple[torch.Tensor, ...]]] = []
        self._copied: List[Optional[List[torch.cuda.Event]]] = []
        # the feature cache: per device, (visual, inertial) over its block
        # of lanes, and the prototype's features (``_allocate``)
        self._feats: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._proto_feats: List[Tuple[torch.Tensor, torch.Tensor]] = []

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
        if self._batch is not None:
            self._fill(*divmod(sid, self._per))
        self._free.append(sid)

    # -- the lane batch ----------------------------------------------------
    def _set_proto(self, imgs, imus, ts) -> None:
        self._proto = (np.zeros_like(np.asarray(imgs, np.float32)),
                       np.zeros_like(np.asarray(imus, np.float32)),
                       np.arange(len(ts), dtype=np.float32) * 0.1)

    def _fill(self, part: int, rows) -> None:
        """Slots ``rows`` (an index or a slice) of block ``part`` back to
        the prototype, and their rows of the feature cache to its
        features."""
        with torch.inference_mode():
            for blocks, a in zip(self._batch, self._proto):
                blocks[part][rows].copy_(torch.from_numpy(a).to(blocks[part].device))
            for cache, f in zip(self._feats[part], self._proto_feats[part]):
                cache[rows].copy_(f)

    def _allocate(self) -> None:
        """The lane batch at the prototype's shapes and the feature cache,
        every slot at the prototype and every row at its features; kept
        where the batch's shapes already are the prototype's."""
        shapes = [(self._per, *a.shape) for a in self._proto]
        if self._batch is None or [tuple(b[0].shape) for b in self._batch] != shapes:
            self._batch, self._pinned, self._copied = ([], [], []), [], []
            with torch.inference_mode():
                for dev in self._devices:
                    for blocks, shape in zip(self._batch, shapes):
                        blocks.append(torch.empty(shape, dtype=torch.float32, device=dev))
                    cuda = dev.type == "cuda"
                    self._pinned.append(tuple(torch.empty(shape, dtype=torch.float32,
                                                          pin_memory=True)
                                              for shape in shapes) if cuda else None)
                    self._copied.append([torch.cuda.Event() for _ in range(self._per)]
                                        if cuda else None)
                self._feats, self._proto_feats = self._infer.feature_cache(
                    *(torch.from_numpy(a) for a in self._proto[:2]), self._per)
        for part in range(len(self._devices)):
            self._fill(part, slice(None))

    def _lane_window(self, lane: int, window: Window) -> Window:
        """Submitted ``window`` of ``lane`` as float32 on the session's
        re-based clock."""
        imgs, imus, ts = window
        ts = np.asarray(ts, np.float64)
        if lane in self._fresh:
            # re-base this session's clock to 0 (cold-start semantics)
            self._t_off[lane] = ts[0]
            self._fresh.discard(lane)
        return (np.ascontiguousarray(imgs, np.float32), np.ascontiguousarray(imus, np.float32),
                (ts - self._t_off[lane]).astype(np.float32))

    def _stage(self, staged: Dict[int, Window]) -> None:
        """The submitted windows into their lanes' slots of the batch."""
        with torch.inference_mode():
            with span("ode_vio.serve.stack"):
                for lane, w in staged.items():
                    part, local = divmod(lane, self._per)
                    host = self._pinned[part]
                    if host is None:
                        host = [blocks[part] for blocks in self._batch]
                    else:
                        self._copied[part][local].synchronize()
                    for slot, a in zip(host, w):
                        slot[local].copy_(torch.from_numpy(a))
            with span("ode_vio.lanes.h2d"):
                for lane in staged:
                    part, local = divmod(lane, self._per)
                    if self._pinned[part] is None:
                        continue
                    for blocks, src in zip(self._batch, self._pinned[part]):
                        blocks[part][local].copy_(src[local], non_blocking=True)
                    self._copied[part][local].record(
                        torch.cuda.current_stream(self._devices[part]))
        count("ode_vio.serve.lanes_staged", len(staged))

    # -- serving -----------------------------------------------------------
    def step(self, windows: Dict[int, Window]) -> Dict[int, np.ndarray]:
        if not windows:
            return {}
        for sid in windows:
            if sid not in self._open:
                raise KeyError(f"session {sid} is not open")
        if self._batch is None:
            self._set_proto(*next(iter(windows.values())))
            self._allocate()
        want = tuple(a.shape for a in self._proto)
        for sid, w in windows.items():
            got = tuple(np.shape(a) for a in w)
            if got != want:
                raise ValueError(f"session {sid}'s window has shapes (imgs, imus, ts) {got}; "
                                 f"the lane batch's slots are {want}")
        with span("ode_vio.serve.step"):
            cold = {}
            if self._cold_mask and self._carry is not None:
                # sessions serving their first window start afresh beside
                # the carried lanes (the first step has no carry: all do)
                fresh = np.array([ln in windows and ln in self._fresh for ln in range(self.N)])
                if fresh.any():
                    cold["cold"] = fresh
            with span("ode_vio.serve.gather"):
                staged = {lane: self._lane_window(lane, w) for lane, w in windows.items()}
            self._stage(staged)
            active = np.array([ln in windows for ln in range(self.N)])
            poses, carry = self._infer(*self._batch, self._carry, active=active, **cold)
            with span("ode_vio.serve.carry"):
                # lanes that did not really start yet stay zeroed
                old = (self._carry if self._carry is not None
                       else [_leaves(torch.zeros_like, c) for c in carry])
                masks = torch.from_numpy(active).split(self._per)
                self._carry = [_select_lanes(m.to(_first_leaf(c).device), c, o, self._axis)
                               for m, c, o in zip(masks, carry, old)]
                poses = poses.numpy()
        return {sid: poses[sid] for sid in windows}

    def warmup(self, proto: Window) -> None:
        """Run the cold-start forward once with the encoders at every
        bucket of submitted lanes, then the carried forward, on prototype
        lanes shaped like ``proto`` (building the kernels and the
        convolutions' plans and warming the caches) without a trace: every
        slot of the lane batch is left at the prototype and every row of
        the feature cache at its features, the carry stays unset and the
        counters are reset afterwards."""
        self._set_proto(*proto)
        self._allocate()
        lanes = np.arange(self.N) % self._per
        for k in sorted({encoder_bucket(n, self._per) for n in range(1, self._per + 1)}):
            _, carry = self._infer(*self._batch, None, active=lanes < k)
        self._infer(*self._batch, carry, active=np.zeros(self.N, bool))[0].cpu()
        for part in range(len(self._devices)):
            self._fill(part, slice(None))
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
