"""Operation and byte counts against hand counts for small shapes."""

import pytest

from vio_bench import flops, roofline


def test_trunk_by_hand():
    # 64x128 input: conv outputs 32x64, 16x32, 8x16, 8x16, 4x8, 4x8, 2x4, 2x4, 1x2
    hand = 2 * (64 * 6 * 49 * 32 * 64 + 128 * 64 * 25 * 16 * 32 + 256 * 128 * 25 * 8 * 16
                + 256 * 256 * 9 * 8 * 16 + 512 * 256 * 9 * 4 * 8 + 512 * 512 * 9 * 4 * 8
                + 512 * 512 * 9 * 2 * 4 + 512 * 512 * 9 * 2 * 4 + 1024 * 512 * 9 * 1 * 2)
    assert flops.trunk_per_pair(64, 128) == hand


def model(kind="ode-rnn", **kw):
    m = {"model_type": kind, "img_h": 64, "img_w": 128, "v_f_len": 32, "i_f_len": 16,
         "ode_hidden_dim": 8, "ode_fn_num_layers": 2, "rnn_num_layers": 2,
         "cde_hidden_dim": 4, "cde_fn_num_layers": 1, "fuse_method": "soft", "seq_len": 3,
         "compute_dtype": "bfloat16"}
    m.update(kw)
    return m


def test_encoders_by_hand():
    m = model()
    visual = flops.trunk_per_pair(64, 128) + 2 * 32 * 1024 * 1 * 2
    inertial = 2 * 11 * 3 * (64 * 6 + 128 * 64 + 256 * 128) + 2 * 16 * 256 * 11
    assert flops.encoders_per_interval(m) == visual + inertial


@pytest.mark.parametrize("kind,weights", [("ode-rnn", 48 * 8 + 8 * 8 + 8 * 48),
                                          ("cde", 4 * 4 + 4 * 20 + 4 * 5), ("rnn", 0)])
def test_field_weights_by_hand(kind, weights):
    assert flops.field_weights(model(kind)) == weights


def test_window_flops_split_by_precision():
    m = model()
    bf16, f32 = flops.window_flops(m, windows=2, evals=10)
    assert bf16 == 2 * 2 * flops.encoders_per_interval(m)
    core = 2 * 48 * 48 + 2 * 2 * 2 * 48 * 48 + 2 * (48 * 128 + 128 * 6)
    assert f32 == 2 * 2 * core + 2 * 10 * flops.field_weights(m)
    assert flops.window_flops(dict(m, compute_dtype="float32"), 2, 10) == (0, bf16 + f32)


def test_bounds():
    assert roofline.solver_bound_s(1000, 2_000_000, 10) == pytest.approx(1000 * 4e6 / 67e12)
    assert roofline.solver_bound_s(1, 1, 3_350_000_000) == pytest.approx(1e-3)
    assert roofline.least_time_s(989e12, 67e12) == pytest.approx(2.0)
    assert roofline.share_pct(1.0, 4.0) == pytest.approx(25.0)
    assert roofline.share_pct(1.0, 0.0) is None
