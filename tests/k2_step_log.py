"""What K2's step log (``cuda_kernels.fused_cde_solve(..., log_steps=True)``)
has to hold, on the card and in its plain version."""

import numpy as np


def assert_step_log_holds(out, logged, path_ts, eval_ts):
    """``logged``, K2's outputs with its step log, against ``out``, those
    of the same call without: the same bits; per row, its accepted and
    rejected attempts are its counts; in each segment the attempts run in
    order from the segment's start (a rejected one from where the last
    accepted ended, an accepted one on to ``t + h`` or, clamped, onto the
    segment's end), and the segments that do not reach their end are the
    row's incomplete ones."""
    *same, steps = logged
    for a, b in zip(out, same):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    steps = steps.cpu().numpy()
    h = steps[..., 1]
    acc, rej, inc = (x.cpu().numpy() for x in out[2:])
    np.testing.assert_array_equal((h > 0).sum((1, 2)), acc)
    np.testing.assert_array_equal((h < 0).sum((1, 2)), rej)
    through = np.concatenate([path_ts.cpu().numpy()[:, :1], eval_ts.cpu().numpy()], 1)
    n, E = eval_ts.shape
    short = np.zeros(n, np.int64)
    for r in range(n):
        for j in range(E):
            t, t1 = through[r, j], through[r, j + 1]
            attempts = steps[r, j][h[r, j] != 0]
            assert len(attempts) == 0 or attempts[0, 0] == t
            for ta, ha in attempts:
                assert ta == t, (r, j)
                if ha > 0:
                    t = t1 if ha == np.float32(t1 - ta) else np.float32(ta + ha)
            assert not (h[r, j, len(attempts):] != 0).any()
            short[r] += bool(t1 - t > 0)
    np.testing.assert_array_equal(short, inc)
