"""Kernels K1 (fused_ode_solve), K2 (fused_cde_solve) and K3
(fused_dropout) against their plain PyTorch versions on the card. These tests need a CUDA device and
skip without one; this file imports no JAX, so on the GPU machine they run
from the repository's root with

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

K2's cases are chip_smoke.py's CDE_CASES, checked by its check_cde_case;
K3's are its DROPOUT_CASES, checked by check_dropout_case."""

import dataclasses

import numpy as np
import pytest
import torch

from ode_vio_tpu_torch.ops import cuda_kernels

KW = dict(activation="softplus", rtol=1e-2, atol=1e-6, max_steps=64)


def problem(n, feat, hidden, zero_rows, seed, gain=1.0, dt0_all=None):
    rng = np.random.default_rng(seed)
    sizes = [feat, hidden, hidden, feat]
    layers = [(torch.from_numpy((gain * rng.standard_normal((sizes[i + 1], sizes[i])) *
                                 np.sqrt(2.0 / sizes[i])).astype(np.float32)).cuda(),
               torch.from_numpy((0.01 * rng.standard_normal(sizes[i + 1])).astype(np.float32)).cuda())
              for i in range(3)]
    y0 = np.tanh(rng.standard_normal((n, feat))).astype(np.float32)
    t0 = rng.uniform(0.0, 0.5, n).astype(np.float32)
    t1 = (t0 + rng.uniform(0.08, 0.13, n)).astype(np.float32)
    t1[list(zero_rows)] = t0[list(zero_rows)]
    dt0 = (10.0 ** rng.uniform(-4, -1.5, n)).astype(np.float32)
    if dt0_all is not None:
        dt0[:] = dt0_all
    return layers, *(torch.from_numpy(a).cuda() for a in (y0, t0, t1, dt0))


@pytest.mark.gpu
@pytest.mark.parametrize("n,feat,hidden,zero_rows,gain,dt0_all,over,must_reach", [
    (12, 768, 1024, (3, 7), 1.0, None, {}, ()),  # flagship field, 3 layers x 4 lanes
    (5, 768, 1024, (2,), 1.0, None, {}, ()),     # ragged row count
    (1, 768, 1024, (), 1.0, None, {}, ()),       # one row
    (96, 768, 1024, (4, 50), 1.0, None, {}, ()),  # 32 sessions x 3 layers: row chunks
    (800, 768, 1024, (4, 500), 1.0, None, {}, ()),  # more rows than one launch takes
    # twice the flagship's widths, too wide for the blocks' shared memory:
    # the weights are read from global memory (the streamed path)
    (12, 1536, 2048, (1,), 1.0, None, {}, ()),
    (7, 30, 20, (0,), 1.0, None, {}, ()),        # widths not a multiple of 4: the scalar path
    # a steeper field (weights x3; steeper amplifies the summation-order
    # differences past y's tolerance) from dt0 = 0.1 at a tighter rtol:
    # rejected steps
    (12, 768, 1024, (), 3.0, 0.1, {"rtol": 1e-4, "atol": 1e-7}, (3,)),
    # the same with a budget of 3 steps: rejected steps, then out of budget
    (12, 768, 1024, (5,), 3.0, 0.1, {"rtol": 1e-4, "atol": 1e-7, "max_steps": 3}, (3, 4)),
    (12, 768, 1024, (0,), 1.0, 1e-4, {"max_steps": 1}, (4,)),  # one step each
])
def test_kernel_matches_plain_on_gpu(n, feat, hidden, zero_rows, gain, dt0_all, over,
                                     must_reach):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    layers, y0, t0, t1, dt0 = problem(n, feat, hidden, zero_rows, seed=n, gain=gain,
                                      dt0_all=dt0_all)
    kw = dict(KW, **over)
    before = cuda_kernels.fused_ode_solve.launches
    out = cuda_kernels.fused_ode_solve(layers, y0, t0, t1, dt0=dt0, **kw)
    # one launch, or as few as take the rows (each block keeps every row's
    # state); one block per SM; the weights resident in shared memory
    # unless the field is too wide for it; every block passed every barrier
    props = torch.cuda.get_device_properties(0)
    per_launch = cuda_kernels.max_grid_rows((feat, hidden, hidden, feat),
                                            props.multi_processor_count,
                                            props.shared_memory_per_block_optin)
    assert cuda_kernels.fused_ode_solve.launches == before + -(-n // per_launch)
    assert (n > per_launch) == (n == 800)
    plan, work = cuda_kernels.fused_ode_solve.last
    assert plan.n_blocks == props.multi_processor_count
    assert plan.resident == (feat < 1536)
    arrivals, barriers = work.tolist()[:2]
    assert barriers > 0 and arrivals == barriers * plan.n_blocks
    ref = cuda_kernels.fused_ode_solve_plain(
        layers, y0, t0, t1, dt0, method="dopri5", safety=0.9, factor_min=0.2,
        factor_max=10.0, **kw)
    torch.cuda.synchronize()
    # f32 dot products summed in another order than cuBLAS's
    torch.testing.assert_close(out[0], ref[0], rtol=1e-4, atol=1e-5)
    # dt_final of a row that ran out of budget is dt * ratio**(-1/5) after a
    # full step, the ratio carrying the stage sums' rounding: 1e-3. A row
    # that landed on t1 takes it from the landing step, whose error ratio
    # is far below 1 and at the level of that rounding: not compared.
    inc = ref[4].bool()
    torch.testing.assert_close(out[1][inc], ref[1][inc], rtol=1e-3, atol=0.0)
    for k in (2, 3, 4):  # accepted, rejected, incomplete
        assert torch.equal(out[k], ref[k])
    for k in must_reach:  # the controller branch the case is built to reach
        assert int(out[k].sum()) > 0
    assert torch.equal(out[1][list(zero_rows)], dt0[list(zero_rows)])


CDE_CASE_NAMES = ("main", "cubic", "history_prefix", "rde_off_knots", "n5_ragged", "rejects",
                  "budget", "history_c54", "history_c24", "advance_collapsed", "advance_full",
                  "n1", "n32")


@pytest.mark.gpu
@pytest.mark.parametrize("index,name", list(enumerate(CDE_CASE_NAMES)))
def test_k2_matches_plain_on_gpu(index, name):
    """Per-row counts equal, the case's branch reached (rejected steps,
    zero-length segments, the step budget), zs within the rounding's reach,
    one launch counted (three for the 1-row case, whose row must keep its
    bits in another launch and among other rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    case = chip_smoke.CDE_CASES[index]
    assert case[0] == name
    before = cuda_kernels.fused_cde_solve.launches
    out = chip_smoke.check_cde_case(case, torch.device("cuda"), chip_smoke.SEED + index)
    assert out["launches"] == (3 if name == "n1" else 1)
    assert cuda_kernels.fused_cde_solve.launches == before + out["launches"]
    assert out["max_abs_err"] <= out["zs_atol"]
    # one block per SM, the field resident; check_cde_case held every block
    # to every barrier (chip_smoke.grid_launch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert out["resident"] and out["grid"] == [sms, 1, 1]


DROPOUT_CASE_NAMES = tuple(f"{n}_b2" for n in ("conv1", "conv2", "conv3", "conv3_1", "conv4",
                                               "conv4_1", "conv5", "conv5_1", "conv6")) + (
    "odd_f32_r0.2", "odd_f32_r0.5", "odd_f32_r0.999", "unaligned_bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("index,name,channels_last",
                         [(i, n, False) for i, n in enumerate(DROPOUT_CASE_NAMES)]
                         + [(i, n, True) for i, n in enumerate(DROPOUT_CASE_NAMES[:9])])
def test_k3_matches_plain_on_gpu(index, name, channels_last):
    """Forward and backward equal to the plain version bit for bit, one
    launch each way, the keep fraction within 4 sigma; the trunk's shapes
    also channels-last, as cuDNN gives them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke

    case = chip_smoke.DROPOUT_CASES[index]
    assert case[0] == name
    out = chip_smoke.check_dropout_case(case, torch.device("cuda"), chip_smoke.SEED + index,
                                        channels_last=channels_last)
    assert abs(out["keep_sigmas"]) < 4


@pytest.mark.gpu
def test_k3_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.ones(8, 8, device="cuda")
    before = cuda_kernels.fused_dropout.launches
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.fused_dropout(x.t(), 1, 0.5)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        cuda_kernels.fused_dropout(x.double(), 1, 0.5)
    assert cuda_kernels.fused_dropout(x, 1, 0.0) is x
    assert cuda_kernels.fused_dropout.launches == before


@pytest.mark.gpu
def test_eval_stream_kernel_matches_solver_core_on_gpu(tmp_path):
    """A tiny synthetic tree of two sequences streamed through the
    evaluator, batched, on the card: with K1 (one launch per frame interval
    of each window step) and with use_kernels=False (none); the per-frame
    poses within 1e-3 (two error-controlled solves at rtol 1e-2 that sum in
    other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.data.evaluation import KittiEvaluator
    from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.loop import make_infer_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq_len = 5
    root = make_kitti_tree(tmp_path, seqs=("00", "05"), n_frames=23, img_hw=(40, 90),
                           speed_scale=40.0)
    cfg = Config(model=ModelConfig(img_h=32, img_w=64, seq_len=seq_len, v_f_len=64,
                                   i_f_len=32, ode_hidden_dim=32, ode_activation_fn="softplus",
                                   ode_fn_num_layers=2, fuse_method="soft",
                                   compute_dtype="float32"))
    model = create_model(cfg, seed=0)
    poses, launches = [], []
    for use_kernels in (True, False):
        net = create_model(Config(model=dataclasses.replace(cfg.model, use_kernels=use_kernels)),
                           seed=0)
        net.load_state_dict(model.state_dict())
        infer = make_infer_fn(net, fold_bn=True)
        log = []

        def rec(imgs, imus, ts, carry=None):
            out, carry = infer(imgs, imus, ts, carry)
            log.append(out.cpu().numpy())
            return out, carry

        rec.device = infer.device
        ev = KittiEvaluator(root, ("00", "05"), seq_len, (32, 64), 0.3,
                            rng=np.random.default_rng(1))
        before = cuda_kernels.fused_ode_solve.launches
        res = ev.eval(rec, batched=True)
        launches.append(cuda_kernels.fused_ode_solve.launches - before)
        assert all(np.isfinite(r["t_rmse"]) for r in res)
        poses.append(np.stack(log))               # (window steps, lanes, S-1, 6)
    assert launches == [len(poses[0]) * (seq_len - 1), 0]
    np.testing.assert_allclose(poses[0], poses[1], rtol=0, atol=1e-3)


TINY_TRAIN = dict(img_h=32, img_w=64, seq_len=4, v_f_len=32, i_f_len=16, ode_hidden_dim=16,
                  cde_hidden_dim=8, cde_fn_num_layers=2, compute_dtype="float32")


@pytest.mark.gpu
def test_cde_train_step_launches_no_k2_on_gpu():
    """A tiny cde train step on the card: finite loss, the trunk's dropout
    through K3, and no K2 launch; the same model's eval forward launches
    K2 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ode_vio_tpu_torch.config import Config, ModelConfig, TrainConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.loop import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(model_type="cde", **TINY_TRAIN),
                 train=TrainConfig(batch_size=2, freeze_encoder=True))
    model = create_model(cfg, seed=0, train=True)
    state = create_train_state(cfg, model)
    gen = torch.Generator("cuda").manual_seed(0)
    img = torch.rand((2, 4, 32, 64, 3), generator=gen, device="cuda") - 0.5
    imu = torch.randn((2, 31, 6), generator=gen, device="cuda")
    gts = 0.1 * torch.randn((2, 3, 6), generator=gen, device="cuda")
    ts = torch.cumsum(0.08 + 0.05 * torch.rand((2, 4), generator=gen, device="cuda"), 1)
    cuda_kernels.reset_launch_counts()
    state, m = make_train_step(cfg)(state, img, imu, gts, ts)
    assert np.isfinite(float(m["loss"]))
    assert cuda_kernels.fused_cde_solve.launches == 0
    assert cuda_kernels.fused_dropout.launches == 9
    with torch.no_grad():
        state.model.eval()(img, imu, ts)
    assert cuda_kernels.fused_cde_solve.launches == 1


@pytest.mark.gpu
def test_cli_train_checkpoint_restores_bitwise_on_gpu(tmp_path):
    """One tiny cli.train epoch on the card (K3 in the steps, K1 in the
    evaluation), its epoch_000 restored into a fresh state on the card:
    model, optimizer, step and generator bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
    from ode_vio_tpu_torch.cli.train import main as train_main
    from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
    from ode_vio_tpu_torch.training.loop import create_train_state

    root = make_kitti_tree(tmp_path / "kitti", seqs=("05", "07"), n_frames=24, img_hw=(32, 64),
                           speed_scale=50.0)
    flags = ["--data_dir", str(root), "--save_dir", str(tmp_path / "results"),
             "--experiment_name", "gpu", "--img_w", "64", "--img_h", "32", "--seq_len", "4",
             "--v_f_len", "32", "--i_f_len", "16", "--ode_hidden_dim", "16",
             "--compute_dtype", "float32", "--batch_size", "4", "--train_seq", "05",
             "--val_seq", "07", "--epochs_warmup", "1", "--epochs_joint", "0",
             "--epochs_fine", "0", "--freeze_encoder", "--workers", "2"]
    cuda_kernels.reset_launch_counts()
    train_main(flags)
    assert cuda_kernels.fused_dropout.launches > 0 and cuda_kernels.fused_ode_solve.launches > 0
    ckpt = CheckpointManager(tmp_path / "results" / "gpu" / "checkpoints")
    raw = ckpt.restore_raw("epoch_000")
    cfg = config_from_args(build_parser().parse_args(flags))
    state = ckpt.restore("epoch_000", create_train_state(
        cfg, create_model(cfg, seed=3, train=True), seed=9))

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    assert same(state.model.state_dict(), raw["model"])
    assert same(state.optimizer.state_dict(), raw["optimizer"])
    assert state.step == raw["step"] > 0
    assert same(state.generator.get_state(), raw["generator"])
