"""Tracing, FLOP accounting and NaN trapping (counterpart of
``ode_vio_tpu/utils/profiling.py``).

* :func:`annotate` -- a named range in the profiler's trace
  (``torch.profiler.record_function``; it also pushes an NVTX range under
  ``torch.autograd.profiler.emit_nvtx``), where JAX has ``jax.named_scope``.
* :func:`trace` -- a ``torch.profiler`` trace of the host and, on a machine
  with a card, of the card, written as a Chrome/Perfetto trace JSON into a
  directory (``cli.train --profile_dir``).
* :func:`flops_analysis` -- the FLOPs of one call of a function, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.
* :func:`device_memory_stats` -- the CUDA caching allocator's statistics.
* :class:`StepTimer` -- wall-clock step times that wait for the result.
* :func:`set_debug_nans` / :func:`debug_nans` -- ``--debug_nans``: raise
  ``FloatingPointError`` at the first module whose output holds a NaN, as
  ``jax_debug_nans`` does (NaN only, not Inf), and turn on autograd's
  anomaly detection for the backward.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode


def annotate(name: str):
    """A named range of the profiler's trace around a block."""
    return torch.profiler.record_function(name)


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


def _cuda_devices(result) -> set:
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result))
    return set()


class StepTimer:
    """Wall-clock step times; ``measure(result_getter)`` waits for the
    devices of the getter's tensors before it reads the clock."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_getter: Optional[Callable] = None):
        t0 = time.perf_counter()
        yield
        if result_getter is not None:
            for device in _cuda_devices(result_getter()):
                torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


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
