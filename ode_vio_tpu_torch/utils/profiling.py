"""Tracing, FLOP accounting and NaN trapping (counterpart of
``ode_vio_tpu/utils/profiling.py``).

* :func:`span`, :func:`count`, :func:`record`, :func:`clear` -- the
  program's own spans and work counters, switched on by the profiler: while
  a ``torch.profiler`` (or ``emit_nvtx``) collects, a span is a named range
  in its trace (``record_function``, an NVTX range under ``emit_nvtx``),
  where JAX has ``jax.named_scope``, and both are kept in memory on the
  host's ``time.perf_counter()`` clock; otherwise they cost one flag check.
* :func:`trace` -- a ``torch.profiler`` trace of the host and, on a machine
  with a card, of the card, written as a Chrome/Perfetto trace JSON into a
  directory (``cli.train --profile_dir``).
* :func:`flops_analysis` -- the FLOPs of one call of a function, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.
* :func:`device_memory_stats` -- the CUDA caching allocator's statistics.
* :func:`set_debug_nans` / :func:`debug_nans` -- ``--debug_nans``: raise
  ``FloatingPointError`` at the first module whose output holds a NaN, as
  ``jax_debug_nans`` does (NaN only, not Inf), and turn on autograd's
  anomaly detection for the backward.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode


# Whether a profiler is collecting: false with none, and during a
# ``torch.profiler`` schedule's warm-up.
collecting = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One closed span: ``name``, its start and end on the host's
    ``time.perf_counter()`` clock, the name of the program span it lies in
    (None at the top), and ``step``, the ordinal of its top-level span (a
    top-level span carries its own): the spans of one engine step or one
    eval window step share it."""

    name: str
    t0: float
    t1: float
    parent: Optional[str]
    step: int


class Count(NamedTuple):
    """One count as :func:`record` returns it: ``name``, when it was
    counted (``time.perf_counter()``) and its value."""

    name: str
    t: float
    value: int


_spans: List[Span] = []
_counts: list = []            # (name, t, value (a number or a tensor), scale)
_open = threading.local()     # this thread's stack of open spans
_tops = itertools.count()     # the ordinals of top-level spans


class _Range:
    __slots__ = ("name", "rf", "t0", "parent", "step")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            self.parent, self.step = stack[-1].name, stack[-1].step
        else:
            self.parent, self.step = None, next(_tops)
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        _open.stack.pop()
        _spans.append(Span(self.name, self.t0, t1, self.parent, self.step))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A named span around a block (``ode_vio.<layer>.<what>``). With no
    profiler collecting it is one shared no-op context after a single flag
    check: no range, no device operation, no host sync. While one collects
    it is a ``record_function`` range of that name, on the clock of the
    trace's kernels and copies, and a :class:`Span` kept for
    :func:`record`."""
    return _Range(name) if collecting() else _OFF


def count(name: str, value, scale: int = 1) -> None:
    """Add ``value * scale`` to the counter ``name`` while a profiler
    collects (nothing otherwise). ``value`` may be a device tensor of one
    element: it is read by :func:`record`, never here."""
    if collecting():
        _counts.append((name, time.perf_counter(), value, scale))


def record() -> Dict[str, list]:
    """What the spans and counters kept, without clearing it (several
    readers may read one run): ``{"spans": [Span, ...] in closing order,
    "counts": [Count, ...] in counting order}``. Reading a count held as a
    device tensor waits for the device that holds it."""
    return {"spans": list(_spans),
            "counts": [Count(n, t, int(v) * s) for n, t, v, s in _counts]}


def clear() -> None:
    """Forget every span and count kept so far."""
    _spans.clear()
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir, warmup_steps: int = 0):
    """Profile the block: host activity, and the card's where CUDA is
    available; on exit the trace is written to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format, which Perfetto
    and ``chrome://tracing`` open). Yields the profiler.

    With ``warmup_steps`` the collection starts at once and the trace after
    that many ``prof.step()`` calls (torch.profiler's warm-up): on an H100
    a trace begun without one lost, in some runs, the records of its first
    ~40 kernels and copies, which the warm-up steps take instead."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    schedule = None
    if warmup_steps:
        def schedule(step):
            return (torch.profiler.ProfilerAction.WARMUP if step < warmup_steps
                    else torch.profiler.ProfilerAction.RECORD)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def flops_analysis(fn: Callable, *example_args) -> dict:
    """Run ``fn(*example_args)`` once and count its FLOPs: ``{"flops":
    total, "by_op": {op: flops}}``.

    What the count cannot see: operations without a FLOP formula in
    ``FlopCounterMode`` (elementwise ops, BatchNorm, the activations) count
    0, and so do the port's ctypes kernels K1-K3, as a Pallas custom call is
    opaque to XLA's ``cost_analysis``. A loop counts every iteration that
    runs (each step of an adaptive solve on the solver-core path), where
    XLA counts a ``while`` body once."""
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    by_op = counter.get_flop_counts().get("Global", {})
    return {"flops": counter.get_total_flops(),
            "by_op": {str(op): int(n) for op, n in by_op.items()}}


def device_memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current CUDA
    device where there is one), or ``{}`` for the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return dict(torch.cuda.memory_stats(device)) if device.type == "cuda" else {}


def _raise_on_nan(module, inputs, output) -> None:
    tensors = output if isinstance(output, (list, tuple)) else [output]
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and torch.isnan(t).any():
            raise FloatingPointError(f"debug_nans: NaN in the output of {type(module).__name__}")


_nan_hook = None


def set_debug_nans(on: bool) -> bool:
    """Switch the process-wide NaN trap on or off; returns whether it was
    on. On: a global forward hook on every module raises
    ``FloatingPointError`` naming the first module whose floating output
    (a tensor, or a tuple or list of them) holds a NaN, and autograd's
    anomaly detection names the backward function that makes one. Off:
    the hook removed and anomaly detection off."""
    global _nan_hook
    was = _nan_hook is not None
    if on and not was:
        _nan_hook = torch.nn.modules.module.register_module_forward_hook(_raise_on_nan)
    elif was and not on:
        _nan_hook.remove()
        _nan_hook = None
    torch.autograd.set_detect_anomaly(on)
    return was


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """The NaN trap set to ``on`` for a block, then as it was."""
    was = set_debug_nans(on)
    try:
        yield
    finally:
        set_debug_nans(was)
