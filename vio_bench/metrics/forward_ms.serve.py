"""forward_ms.serve: the median over the window's engine steps of the host
time in the program's model call and the wait for its poses, from its own
spans (``ode_vio_tpu_torch/utils/profiling.py``, recorded while the
profiler collects): ``ode_vio.lanes.forward`` (each replica's call: the
launches and any sync inside) and ``lanes.readback`` (the poses copied to
the host). A program span counts in the benchmark's ``engine_step`` span
that holds it; spans outside every one are left out. Moves
window_p95_ms."""

import bisect
import statistics

NAMES = ("ode_vio.lanes.forward", "ode_vio.lanes.readback")


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
