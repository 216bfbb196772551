"""The plain reference against the measured program at tiny widths on the
CPU: one window per row, cold and carried, the program's solver core in
float32 beside the reference in float32 on the same weights and inputs;
and with the encoders in bf16 and BatchNorm folded, as the serving cells
run them, the reference at the same precision beside the program's
inference callable."""

import pytest
import torch

from vio_bench.harness import program_config
from vio_bench.reference.model import ReferenceModel
from vio_bench.tests.tiny import tiny_cell
from vio_bench.weights import check_layout, make_weights


def inputs(m, seed, B=3):
    g = torch.Generator().manual_seed(seed)
    S = m["seq_len"]
    img = torch.rand(B, S, m["img_h"], m["img_w"], 3, generator=g) - 0.5
    imu = torch.randn(B, 10 * (S - 1) + 1, 6, generator=g)
    ts = torch.cumsum(0.1 + 0.3 * torch.rand(B, S, generator=g), 1)
    return img, imu, ts - ts[:, :1]


@pytest.mark.parametrize("config,core", [("odevio-odernn", "ode-rnn"), ("odevio-rnn", "rnn"),
                                         ("odevio-odernn", "cde")])
def test_reference_matches_the_program(config, core):
    from ode_vio_tpu_torch.models.deepvio import DeepVIO

    c = tiny_cell(config, model_type=core)["config_file"]
    m = c["model"]
    weights = make_weights(m, 11, "cpu")
    cfg = program_config(c)
    net = DeepVIO(cfg.model, cfg.solver, cfg.cde_solver_cfg).eval()
    check_layout(weights, net.state_dict())
    net.load_state_dict(weights)
    ref = ReferenceModel(m, c["solver"], c["cde_solver"], weights)
    img, imu, ts = inputs(m, 0)
    img2, imu2, ts2 = inputs(m, 1)
    ts2 = ts2 + ts[:, -1:] + 0.1
    with torch.no_grad():
        p1, h1, _ = net(img, imu, ts)
        p2, _, _ = net(img2, imu2, ts2, h1)
        r1, c1, ev1 = ref.window(img, imu, ts)
        r2, _, ev2 = ref.window(img2, imu2, ts2, c1,
                                torch.zeros(3, dtype=torch.bool))
    scale = float(r1.abs().max())
    # the same float32 arithmetic: rounding apart at most
    assert float((p1 - r1).abs().max()) <= 1e-5 * scale
    assert float((p2 - r2).abs().max()) <= 1e-5 * scale
    assert (ev1 > 0) == (m["model_type"] != "rnn")


def test_weights_come_from_the_seed():
    m = tiny_cell()["config_file"]["model"]
    a, b, c = (make_weights(m, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Image_net.conv1.0.weight"], c["Image_net.conv1.0.weight"])
    w = a["Pose_net.ode_func.net.0.weight"]
    assert abs(float(w.std()) - (2.0 / w.shape[1]) ** 0.5) < 0.2 * (2.0 / w.shape[1]) ** 0.5


@pytest.mark.parametrize("config", ["odevio-odernn", "odevio-rnn"])
def test_bf16_encoders_match_the_program_folded(config):
    """The reference's bf16 encoders (each layer's inputs, weights and
    outputs rounded, BatchNorm folded first) sit far closer to the
    program's folded bf16 inference than a float32 reference does. What
    remains is the sums' order: where it tips one output's rounding, the
    one-ulp difference spreads layer by layer (on the CPU, to half the
    last convolution's outputs), some tenths of a percent of the poses."""
    from ode_vio_tpu_torch.models.deepvio import DeepVIO
    from ode_vio_tpu_torch.training.loop import make_infer_fn

    c = tiny_cell(config, compute_dtype="bfloat16")["config_file"]
    m = c["model"]
    weights = make_weights(m, 12, "cpu")
    # BatchNorm away from its init, so that folding changes the kernels
    g = torch.Generator().manual_seed(3)
    for k in weights:
        if k.endswith(".running_var"):
            weights[k] = 0.5 + torch.rand(weights[k].shape, generator=g)
        elif k.endswith(".running_mean"):
            weights[k] = 0.1 * torch.randn(weights[k].shape, generator=g)
    cfg = program_config(c)
    with torch.device("meta"):
        skeleton = DeepVIO(cfg.model, cfg.solver, cfg.cde_solver_cfg)
    infer = make_infer_fn(skeleton, weights, fold_bn=True, device="cpu")
    img, imu, ts = inputs(m, 4)
    imu = imu + torch.tensor([0, 0, 9.81, 0, 0, 0])   # gravity, as the IMU reads it
    with torch.no_grad():
        got, _ = infer(img, imu, ts)
        want, _, _ = ReferenceModel(m, c["solver"], c["cde_solver"], weights,
                                    fold_bn=True).window(img, imu, ts)
        f32, _, _ = ReferenceModel(m, c["solver"], c["cde_solver"], weights, fold_bn=True,
                                   encoders="float32").window(img, imu, ts)
    scale = float(want.abs().max())
    gap = float((got.float() - want).abs().max()) / scale
    gap_f32 = float((got.float() - f32).abs().max()) / scale
    assert gap <= 4e-3 and gap <= gap_f32 / 5, (gap, gap_f32)


@pytest.mark.parametrize("core", ["bfloat16", "tf32"])
def test_a_lower_pose_core_moves_the_poses(core):
    c = tiny_cell()["config_file"]
    m = c["model"]
    weights = make_weights(m, 13, "cpu")
    img, imu, ts = inputs(m, 5)
    with torch.no_grad():
        want, _, _ = ReferenceModel(m, c["solver"], c["cde_solver"], weights).window(img, imu, ts)
        low, _, _ = ReferenceModel(m, c["solver"], c["cde_solver"], weights,
                                   core=core).window(img, imu, ts)
    gap = float((low - want).abs().max()) / float(want.abs().max())
    assert (1e-4 if core == "tf32" else 1e-3) < gap < 0.2


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -10])
    from vio_bench.reference.model import _round_tf32

    assert _round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0 - 2 ** -9]
