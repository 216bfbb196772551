"""k2_roofline.serve: K2 (``fused_cde_solve_kernel``)'s share of its
roofline in the traced serving window: the least time of the field
evaluations that the plain reference needs for the windows served (the
cde field's multiply-adds, its (H, H+1) product with the path's slope
included, 2 flops each at the float32 peak, or the field's bytes read
once a launch at the HBM rate), over K2's device time. The evaluations
are counted by the reference, never by the kernel; replayed idle lanes
are work K2 does that no window needed. Moves window_p95_ms."""

from vio_bench import flops
from vio_bench.roofline import share_pct, solver_bound_s

KERNEL = "fused_cde_solve_kernel"


def read(run):
    if run.trace is None or "evals" not in run.counts:
        return None
    took = run.trace.device_time_s(KERNEL, cat="kernel")
    weights = flops.field_weights(run.config["model"])
    nbytes = run.trace.count(KERNEL) * 4 * weights
    return share_pct(solver_bound_s(run.counts["evals"], weights, nbytes), took)
