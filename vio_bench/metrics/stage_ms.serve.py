"""stage_ms.serve: the median over the window's engine steps of the host
time the program spends staging a step's lanes, from its own spans
(``ode_vio_tpu_torch/utils/profiling.py``, recorded while the profiler
collects): ``ode_vio.serve.gather`` (the lanes' windows), ``serve.stack``
(the batch) and ``lanes.h2d`` (each replica's copy to its card). A
program span counts in the benchmark's ``engine_step`` span that holds
it; spans outside every one are left out. Moves window_p95_ms."""

import bisect
import statistics

NAMES = ("ode_vio.serve.gather", "ode_vio.serve.stack", "ode_vio.lanes.h2d")


def per_step(steps, spans, names):
    """Seconds of ``spans`` named in ``names`` inside each of ``steps``
    ((start, end) pairs that do not overlap), for the steps holding any."""
    steps = sorted(steps)
    starts = [a for a, _ in steps]
    took = {}
    for s in spans:
        if s.name not in names:
            continue
        i = bisect.bisect_right(starts, s.t0) - 1
        if i >= 0 and s.t1 <= steps[i][1]:
            took[i] = took.get(i, 0.0) + (s.t1 - s.t0)
    return list(took.values())


def read(run):
    try:
        from ode_vio_tpu_torch.utils.profiling import record
    except ImportError:   # a program without its own spans
        return None
    took = per_step(run.spans.by_name.get("engine_step", []), record()["spans"], NAMES)
    return statistics.median(took) * 1e3 if took else None
