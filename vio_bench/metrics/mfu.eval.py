"""mfu.eval: the least time of the model's work on the eval windows of
real lanes (encoders at the bf16 peak, the pose core at the float32 peak,
the solver's field evaluations as the plain reference counts them), over
the window's time. Moves eval_frames_per_s."""

from vio_bench.roofline import least_time_s, share_pct


def read(run):
    if "bf16_flops" not in run.counts or "elapsed_s" not in run.counts:
        return None
    return share_pct(least_time_s(run.counts["bf16_flops"], run.counts["f32_flops"]),
                     run.counts["elapsed_s"])
