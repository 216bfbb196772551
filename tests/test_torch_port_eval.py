"""The streaming-evaluation slice: the port's data/evaluation.py against
the JAX package's. The KITTI metric within 1e-9 (the same float64 numpy
in both); eval partitions exactly equal (ragged tail, a sequence shorter
than a window, eval frame dropout); an oracle scores zero; and the two
KittiEvaluators on the same bridged weights, batched and sequential, over
a synthetic tree whose sequences cover the 100 m segment: per-frame poses
within atol 1e-4 (f32 through encoders, adaptive solves and the RNN
stack, sums taken in another order) and t_rel / r_rel / t_rmse / r_rmse
within rtol 1e-3."""

import math

import numpy as np
import pytest

from ode_vio_tpu.data import evaluation as jev
from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.training.loop import make_infer_fn as jax_infer_fn
from ode_vio_tpu_torch.data import evaluation as tev
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.training.loop import make_infer_fn

from torch_port_helpers import configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METRICS = ("t_rel", "r_rel", "t_rmse", "r_rmse")


def straight(n, step=2.0):
    rel = np.zeros((n, 6))
    rel[:, 5] = step
    return rel


def rotated(n):
    rel = straight(n)
    rel[:, 1] += 0.002
    return rel


# JAX's metric cases (tests/test_eval.py), plus a noisy one
METRIC_CASES = {
    "identical": lambda: (straight(120), straight(120)),
    "scale_error": lambda: (straight(120, 2.2), straight(120)),
    "rotation_error": lambda: (rotated(120), straight(120)),
    "short_sequence": lambda: (straight(10), straight(10)),
    "noisy": lambda: (straight(150) + 0.01 * np.random.default_rng(0).standard_normal((150, 6)),
                      straight(150, 1.9)),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_kitti_eval_equal(case):
    est, gt = METRIC_CASES[case]()
    t, j = tev.kitti_eval(est, gt), jev.kitti_eval(est, gt)
    for k in METRICS:
        if math.isnan(j[k]):
            assert math.isnan(t[k]), k
        else:
            assert t[k] == pytest.approx(j[k], rel=1e-9, abs=1e-9), k
    np.testing.assert_array_equal(np.asarray(t["est_global"]), np.asarray(j["est_global"]))
    np.testing.assert_array_equal(t["speed"], j["speed"])


# ---------------------------------------------------------------------------
# Partitions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two sequences of 34 and 6 frames (a ragged tail at seq_len 11, and
    a sequence shorter than one window)."""
    base = tmp_path_factory.mktemp("eval_tree")
    make_kitti_tree(base, seqs=("05",), n_frames=34, img_hw=(32, 64))
    make_kitti_tree(base / "short", seqs=("05",), n_frames=6, img_hw=(32, 64), seed=1)
    return base


PARTITIONS = {
    "ragged_tail": ("", 11, 0.0),
    "short_sequence": ("short", 11, 0.0),
    "eval_dropout": ("", 11, 0.5),
    "seq_len_4_dropout": ("", 4, 0.3),
}


@pytest.mark.parametrize("case", sorted(PARTITIONS))
def test_eval_partition_equal(tree, case):
    sub, seq_len, dropout = PARTITIONS[case]
    parts = [ev.EvalPartition(tree / sub, "05", seq_len, (32, 64), dropout,
                              np.random.default_rng(7)) for ev in (tev, jev)]
    t, j = parts
    assert len(t) == len(j) and t.seq.num_frames == j.seq.num_frames
    for i in range(len(j)):
        assert t.windows[i]["paths"] == j.windows[i]["paths"]
        assert t.windows[i]["pad"] == j.windows[i]["pad"]
        for k in ("ts", "imus", "gts"):
            np.testing.assert_array_equal(t.windows[i][k], j.windows[i][k])
        a, b = t[i], j[i]
        assert a.valid == b.valid
        for k in ("imgs", "imus", "ts", "gts"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert sum(t[i].valid for i in range(len(t))) == t.seq.num_frames - 1
    if case == "short_sequence":
        assert len(t) == 1 and t[0].valid == 5 and t[0].imgs.shape[0] == 11


def test_oracle_infer_gives_zero_rmse(tree):
    """An infer that returns the ground-truth relative poses scores zero,
    batched and sequential; the timing adds up the scored frames."""
    ev = tev.KittiEvaluator(tree, val_seqs=("05",), seq_len=11, img_hw=(32, 64))
    part = ev.partitions[0]

    def oracle(imgs, imus, ts, carry=None):
        i = 0 if carry is None else carry + 1
        padded = np.zeros((1, part.seq_len - 1, 6), np.float32)
        gts = part.windows[i]["gts"]
        padded[0, : len(gts)] = gts
        return padded, i

    for batched in (False, True):
        errs = ev.eval(oracle, batched=batched)
        assert errs[0]["t_rmse"] == pytest.approx(0.0, abs=1e-7)
        assert errs[0]["r_rmse"] == pytest.approx(0.0, abs=1e-7)
    assert ev.timing["frames"] == 2 * (part.seq.num_frames - 1)
    assert ev.timing["steps"] == 2 * len(part)
    assert 0.0 <= ev.timing["decode_wait_s"] <= ev.timing["wall_s"]


@pytest.mark.parametrize("n_runs", [1, 3])
def test_summarize_runs_equal(n_runs):
    rng = np.random.default_rng(n_runs)
    runs = [[{k: float(rng.uniform(0, 5)) for k in METRICS} for _ in range(2)]
            for _ in range(n_runs)]
    runs[0][1]["t_rel"] = float("nan")
    assert tev.summarize_runs(runs, ("05", "07")) == jev.summarize_runs(runs, ("05", "07"))


# ---------------------------------------------------------------------------
# The evaluators on the same weights
# ---------------------------------------------------------------------------

SEQS = ("00", "05")
SEQ_LEN = 5
HW = (32, 64)


def recording(infer, log):
    """``infer`` with every call's poses appended to ``log`` as numpy."""
    def rec(imgs, imus, ts, carry=None):
        poses, carry = infer(imgs, imus, ts, carry)
        log.append(np.array(poses.cpu() if hasattr(poses, "cpu") else poses))
        return poses, carry

    rec.device = getattr(infer, "device", None)
    return rec


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A tree of two 30-frame sequences at ~4 m per frame (over 100 m, so
    t_rel and r_rel are finite), written at 40x90 and decoded to the
    model's 32x64; the JAX infer and the port's on bridged weights, both
    with BatchNorm folded."""
    root = make_kitti_tree(tmp_path_factory.mktemp("eval_models"), seqs=SEQS, n_frames=30,
                           img_hw=(40, 90), speed_scale=40.0)
    jc, tc = configs(seq_len=SEQ_LEN, img_h=HW[0], img_w=HW[1])
    model, variables = jax_model(jc)
    jinfer = jax_infer_fn(model, variables, fold_bn=True)
    net = DeepVIO(tc.model, tc.solver)
    tinfer = make_infer_fn(net, from_jax_variables(variables, tc.model), fold_bn=True,
                           device="cpu")
    return root, jinfer, tinfer


def evaluator(ev, root, dropout=0.0, seed=0):
    return ev.KittiEvaluator(root, SEQS, SEQ_LEN, HW, dropout,
                             rng=np.random.default_rng(seed))


@pytest.mark.parametrize("batched", [True, False])
def test_evaluator_matches_jax(models, batched):
    root, jinfer, tinfer = models
    logs = [], []
    res_t = evaluator(tev, root, 0.3).eval(recording(tinfer, logs[0]), batched=batched)
    res_j = evaluator(jev, root, 0.3).eval(recording(jinfer, logs[1]), batched=batched)
    assert len(logs[0]) == len(logs[1]) > 2
    for a, b in zip(*logs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for a, b in zip(res_t, res_j):
        assert all(np.isfinite(b[k]) for k in METRICS)
        for k in METRICS:
            assert a[k] == pytest.approx(b[k], rel=1e-3), k


def test_eval_runs_with_pad_to(models):
    """Three repeats of the two sequences as 6 lanes padded to 8: each
    evaluator's results equal its own batched stream's, and are assigned
    per evaluator."""
    root, _, tinfer = models
    runs = tev.eval_runs(tinfer, [evaluator(tev, root, 0.25, 100 + r) for r in range(3)],
                         pad_to=8)
    assert len(runs) == 3
    for r, run in enumerate(runs):
        alone = evaluator(tev, root, 0.25, 100 + r)
        ref = alone.eval(tinfer, batched=True)
        assert len(alone.results) == 2
        for a, b in zip(run, ref):
            for k in METRICS:
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-6), k
