"""mfu.serve: the least time of the model's work on the windows really
served (encoders at the bf16 peak, the pose core at the float32 peak, the
solver's field evaluations as the plain reference counts them for the
same inputs; idle lanes replayed by the engine are waste and not counted),
over the summed engine step times. Moves window_p95_ms."""

from vio_bench.roofline import least_time_s, share_pct


def read(run):
    if "bf16_flops" not in run.counts:
        return None
    return share_pct(least_time_s(run.counts["bf16_flops"], run.counts["f32_flops"]),
                     sum(run.spans.durations("engine_step")))
