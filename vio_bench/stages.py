"""The measured program's pose core, watched at its boundary, and the gaps
the correctness check compares.

The poses alone cannot tell a pose core run one precision lower from a
sound one: the bf16 encoders' rounding, whose order the reference cannot
follow, moves the poses about as far. So the check also compares each
stage by itself, on a sample of the window's calls:

* the encoders: the features the program handed its pose core, against
  the reference's encoders on the same windows;
* the pose core: the poses the program's core returned, against the
  reference's core run from the same features and the same carry, the
  program's own.

:class:`CoreCalls` records that sample: while it watches, every call of
the program's pose core class is counted, and every ``every``-th one, from
an offset drawn from the seed, is kept (its features, clock, carry and
poses, cloned on the device).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch


class CoreCalls:
    def __init__(self, core_cls: type, every: int, seed: int):
        self.cls = core_cls
        self.every = every
        self.offset = seed % every
        self.calls = 0
        self.taken: Dict[int, dict] = {}

    def sampled(self, call: int) -> bool:
        return call % self.every == self.offset

    @contextmanager
    def watch(self):
        forward = self.cls.forward

        def watched(module, fv, fi, ts, *args, **kwargs):
            out = forward(module, fv, fi, ts, *args, **kwargs)
            if self.sampled(self.calls):
                prev = kwargs.get("prev", args[0] if args else None)
                self.taken[self.calls] = {
                    "fv": fv.clone(), "fi": fi.clone(), "ts": ts.clone(),
                    "prev": None if prev is None else prev.clone(), "poses": out[0].clone()}
            self.calls += 1
            return out

        self.cls.forward = watched
        try:
            yield self
        finally:
            self.cls.forward = forward


class Gap:
    """The widest ``|got - want|`` over the widest ``|want|``, per part
    (visual and inertial features apart, their scales differing), and
    the largest of the parts' ratios."""

    def __init__(self):
        self.num: Dict[str, float] = {}
        self.den: Dict[str, float] = {}

    def add(self, part: str, got: torch.Tensor, want: torch.Tensor) -> None:
        got, want = got.double(), want.double()
        self.num[part] = max(self.num.get(part, 0.0), float((got - want).abs().max()))
        self.den[part] = max(self.den.get(part, 0.0), float(want.abs().max()))

    def value(self) -> Optional[float]:
        """None where nothing was compared (never a pass)."""
        if not self.num or min(self.den.values()) <= 0:
            return None
        return max(self.num[p] / self.den[p] for p in self.num)


def core_gap(calls: CoreCalls, ref, stand_in=None) -> Gap:
    """The program's core (or the control's ``stand_in``) against the
    reference's, each run from the program's own features and carry of
    the sampled calls."""
    gap = Gap()
    for c in calls.taken.values():
        args = (c["fv"].float(), c["fi"].float(), c["ts"], c["prev"])
        want = ref.core(*args)[0]
        got = c["poses"] if stand_in is None else stand_in.core(*args)[0]
        gap.add("poses", got, want)
    return gap
