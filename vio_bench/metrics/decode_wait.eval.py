"""decode_wait.eval: the evaluator's own share of its wall time spent
waiting for the native decoder's PNG frames (``timing['decode_wait_s'] /
timing['wall_s']`` of ``data/evaluation.py``, summed over the window's
passes). Moves eval_frames_per_s."""


def read(run):
    timing = run.counts.get("timing")
    if not timing or timing["wall_s"] <= 0:
        return None
    return 100.0 * timing["decode_wait_s"] / timing["wall_s"]
