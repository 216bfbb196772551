"""The open-loop session scheduler's due times."""

import numpy as np
import pytest

from vio_bench.traffic.serve import Schedule, nearest_rank

MIX = {"sessions": 6, "camera_hz": 10, "frame_drop": 0.3, "schedule_seed": 7,
       "pool_windows": 5}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 3 * 10 ** 9])
def test_windows_fall_due_at_their_last_frame_inside_the_window(seed):
    sched = Schedule(MIX, 11, 20.0, seed)
    dues = [w[0] for w in sched.windows]
    assert dues == sorted(dues) and 0 <= dues[0] and dues[-1] < 20.0
    by_session = {}
    for due, s, j, times in sched.windows:
        assert due == times[-1] and len(times) == 11
        gaps = np.diff(times) * 10
        assert np.allclose(gaps, np.round(gaps)) and (np.round(gaps) >= 1).all()
        by_session.setdefault(s, []).append((j, times))
    for s, wins in by_session.items():
        assert [j for j, _ in wins] == list(range(len(wins)))
        for (_, a), (_, b) in zip(wins, wins[1:]):
            assert a[-1] == b[0]   # a window starts at the previous one's last frame
        # each session's first window falls due in the window's first span
        assert wins[0][1][-1] < 10 / 0.7 * 0.1 + 1e-9


def test_seeds_reorder_one_multiset_of_work():
    a, b = Schedule(MIX, 11, 30.0, 1), Schedule(MIX, 11, 30.0, 2)
    assert [w[:2] for w in a.windows] != [w[:2] for w in b.windows]
    # about 0.7 windows a second a session, whatever the seed
    for sched in (a, b):
        assert abs(len(sched.windows) - 6 * 30 / (10 / 0.7 * 0.1)) < 0.15 * 6 * 30 / 1.4286


def test_nearest_rank():
    assert nearest_rank(list(range(1, 101)), 0.95) == 95
    assert nearest_rank([3.0], 0.95) == 3.0
