"""k2_useful.serve: the share of K2's row evaluations in the window that a
served window needed: the field evaluations the plain reference counts for
the windows served (``run.counts["evals"]``, which k2_roofline.serve reads
too), over the program's counter ``ode_vio.k2.row_evals``
(``ode_vio_tpu_torch/utils/profiling.py``, counted while the profiler
collects: each K2 launch's lockstep field evaluations times its rows),
counted inside the benchmark's ``engine_step`` spans. Idle lanes replayed
and rows stepped in lockstep until the slowest is done are the rest.
Moves window_p95_ms."""

import bisect

NAME = "ode_vio.k2.row_evals"


def read(run):
    try:
        from ode_vio_tpu_torch.utils.profiling import record
    except ImportError:   # a program without its own counters
        return None
    if not run.counts.get("evals"):
        return None
    steps = sorted(run.spans.by_name.get("engine_step", []))
    starts = [a for a, _ in steps]
    done = 0
    for c in record()["counts"]:
        i = bisect.bisect_right(starts, c.t) - 1
        if c.name == NAME and i >= 0 and c.t <= steps[i][1]:
            done += c.value
    return 100.0 * run.counts["evals"] / done if done else None
