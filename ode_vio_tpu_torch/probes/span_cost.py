"""What one ``utils/profiling.py::span`` costs on the host, in ns per call.

    python ode_vio_tpu_torch/probes/span_cost.py

from the repository's root. It times an empty ``with`` block entered a
million times through a shared ``contextlib.nullcontext`` (the loop's
own cost), through ``span`` with no profiler collecting (the off path: a
flag check), through an unconditional ``torch.profiler.record_function``
with no profiler, and through ``span`` while a ``torch.profiler`` collects
(the CUDA activity too where there is a card). Each figure is the fastest
of three loops."""

import contextlib
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from ode_vio_tpu_torch.utils import profiling  # noqa: E402


def per_call_ns(n: int, make) -> float:
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(n):
            with make("ode_vio.serve.step"):
                pass
        best = min(best, (time.perf_counter() - t) / n * 1e9)
    return best


def main() -> None:
    null = contextlib.nullcontext()
    loop = per_call_ns(10 ** 6, lambda name: null)
    off = per_call_ns(10 ** 6, profiling.span)
    bare = per_call_ns(10 ** 5, torch.profiler.record_function)
    activities = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=activities):
        on = per_call_ns(20000, profiling.span)
    profiling.clear()
    where = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card"
    print(f"span_cost ({where}): empty with-block {loop:.1f} ns; span off {off:.1f} ns "
          f"({off - loop:+.1f} over the empty block); record_function with no profiler "
          f"{bare:.1f} ns; span on {on:.1f} ns")


if __name__ == "__main__":
    main()
