"""k1_roofline.serve: K1 (``fused_ode_solve_kernel``)'s share of its
roofline in the traced serving window: the least time of the field
evaluations that the plain reference needs for the windows served (2
flops a weight at the float32 peak, or the field's bytes read once a
launch at the HBM rate), over K1's device time. Replayed idle lanes are
work K1 does that no window needed. Moves window_p95_ms."""

from vio_bench import flops
from vio_bench.roofline import share_pct, solver_bound_s

KERNEL = "fused_ode_solve_kernel"


def read(run):
    if run.trace is None or "evals" not in run.counts:
        return None
    took = run.trace.device_time_s(KERNEL, cat="kernel")
    weights = flops.field_weights(run.config["model"])
    nbytes = run.trace.count(KERNEL) * 4 * weights
    return share_pct(solver_bound_s(run.counts["evals"], weights, nbytes), took)
