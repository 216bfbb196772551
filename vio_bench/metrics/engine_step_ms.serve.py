"""engine_step_ms.serve: the median host-clock time of one
``StreamingEngine.step`` in the window (the step returns numpy poses, so
it has waited for the device). Moves window_p95_ms."""

import statistics


def read(run):
    steps = run.spans.durations("engine_step")
    return statistics.median(steps) * 1e3 if steps else None
