"""stage_ms.eval: the median over the window's eval steps of the host time
the evaluator spends building and staging a step's lanes, from the
program's own spans (``ode_vio_tpu_torch/utils/profiling.py``, recorded
while the profiler collects): ``ode_vio.eval.assemble`` (each lane's
window from the decoded frames) and ``eval.stage`` (stack and copy to the
card). A step is a program span ``ode_vio.eval.step`` inside one of the
benchmark's ``eval_pass`` spans; the assemble and stage spans count in the
step that holds them. Moves eval_frames_per_s."""

import bisect
import statistics

STEP = "ode_vio.eval.step"
NAMES = ("ode_vio.eval.assemble", "ode_vio.eval.stage")


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
    spans = record()["spans"]
    passes = sorted(run.spans.by_name.get("eval_pass", []))
    starts = [a for a, _ in passes]
    steps = []
    for s in spans:
        i = bisect.bisect_right(starts, s.t0) - 1
        if s.name == STEP and i >= 0 and s.t1 <= passes[i][1]:
            steps.append((s.t0, s.t1))
    took = per_step(steps, spans, NAMES)
    return statistics.median(took) * 1e3 if took else None
