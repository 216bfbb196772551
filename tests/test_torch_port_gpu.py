"""Kernels K1 (fused_ode_solve), K2 (fused_cde_solve) and K3
(fused_dropout) against their plain PyTorch versions on the card, and the
paths that run only there: the int8 trunk convs' GEMM route, s2d, the
export, traces and the NaN trap. These tests need a CUDA device and
skip without one; this file imports no JAX, so on the GPU machine they run
from the repository's root with

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

K2's cases are chip_smoke.py's CDE_CASES, checked by its check_cde_case;
K3's are its DROPOUT_CASES, checked by check_dropout_case. The mesh's
cases (two ranks, and two eval and serving replicas, sharing the one
card) call its train_mesh, serve_mesh and eval_lanes at tiny widths. The
top-level entry points (ode_vio_tpu_torch/entry.py): the entry forward at
tiny widths through K1, and dryrun_multichip(4) with its four ranks
sharing the card, the weights split over the model axis."""

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


def tiny_batch(n_seq, seed=0, t0=0.0):
    """A seeded batch of 2 windows of ``n_seq`` frames on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)
    img = torch.rand((2, n_seq, 32, 64, 3), generator=gen, device="cuda") - 0.5
    imu = torch.randn((2, 10 * (n_seq - 1) + 1, 6), generator=gen, device="cuda")
    gts = 0.1 * torch.randn((2, n_seq - 1, 6), generator=gen, device="cuda")
    ts = t0 + torch.cumsum(0.08 + 0.05 * torch.rand((2, n_seq), generator=gen, device="cuda"), 1)
    return img, imu, gts, ts


@pytest.mark.gpu
def test_carried_step_launches_k3_once_per_trunk_on_gpu():
    """A tiny cde carried step on the card (the window split at k = 2): the
    trunk runs once, so K3 launches 9 times, and no K2 in either segment;
    finite loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ode_vio_tpu_torch.config import Config, ModelConfig, TrainConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.loop import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(model_type="cde", **dict(TINY_TRAIN, seq_len=5)),
                 train=TrainConfig(batch_size=2, freeze_encoder=True))
    state = create_train_state(cfg, create_model(cfg, seed=0, train=True))
    cuda_kernels.reset_launch_counts()
    state, m = make_train_step(cfg, carry=True)(state, *tiny_batch(5, t0=7.0))
    assert np.isfinite(float(m["loss"]))
    assert cuda_kernels.fused_dropout.launches == 9
    assert cuda_kernels.fused_cde_solve.launches == 0


@pytest.mark.gpu
def test_chained_step_memory_is_flat_on_gpu():
    """A chain of 4 streaming steps on the card: the carry comes back
    detached, so the device's peak memory of the 4th step is that of the
    2nd (the first carried step), within 1 %."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ode_vio_tpu_torch.config import Config, ModelConfig, TrainConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.loop import create_train_state, make_streaming_train_step

    cfg = Config(model=ModelConfig(**TINY_TRAIN),
                 train=TrainConfig(batch_size=2, freeze_encoder=True, tbptt_chain=4))
    state = create_train_state(cfg, create_model(cfg, seed=0, train=True))
    step = make_streaming_train_step(cfg)
    hc, peaks = None, []
    for i in range(4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m, hc = step(state, *tiny_batch(4, seed=i, t0=0.4 * i), hc)
        assert np.isfinite(float(m["loss"])) and not hc.requires_grad
        peaks.append(torch.cuda.max_memory_allocated())
    assert peaks[3] <= 1.01 * peaks[1], peaks


@pytest.mark.gpu
def test_rnn_engine_matches_cpu_on_gpu():
    """The tiny rnn core (float32, TF32 off) behind StreamingEngine on the
    card and on the CPU, the same weights and windows, a session carried
    over three windows and one opened late: poses within 1e-4; K1 and K2
    never launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.serving import StreamingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(model=ModelConfig(model_type="rnn", **TINY_TRAIN))
    model = create_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)

    def window(t0):
        return (rng.random((4, 32, 64, 3), np.float32) - 0.5,
                rng.standard_normal((31, 6)).astype(np.float32),
                t0 + np.cumsum(rng.uniform(0.08, 0.13, 4)))

    plan = [{0: window(0.0)}, {0: window(0.4), 1: window(3.0)}, {0: window(0.8), 1: window(3.4)}]
    cuda_kernels.reset_launch_counts()
    out = []
    for device in ("cuda", "cpu"):
        eng = StreamingEngine(model, max_sessions=2, device=device)
        a, b = eng.open_session(), eng.open_session()
        sids = {0: a, 1: b}
        out.append([eng.step({sids[s]: w for s, w in step.items()}) for step in plan])
    for got, want in zip(*out):
        for sid in got:
            np.testing.assert_allclose(got[sid], want[sid], rtol=0, atol=1e-4)
    assert cuda_kernels.fused_ode_solve.launches == cuda_kernels.fused_cde_solve.launches == 0


@pytest.mark.gpu
def test_adjoint_ode_rnn_step_on_gpu():
    """A tiny ode-rnn train step through the continuous adjoint on the
    card: finite loss, the trunk's dropout through K3 (9 launches), and no
    K1 (the adjoint solves on the solver core)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ode_vio_tpu_torch.config import Config, ModelConfig, SolverConfig, TrainConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.loop import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(**TINY_TRAIN), solver=SolverConfig(unroll_mode="adjoint"),
                 train=TrainConfig(batch_size=2, freeze_encoder=True))
    state = create_train_state(cfg, create_model(cfg, seed=0, train=True))
    cuda_kernels.reset_launch_counts()
    state, m = make_train_step(cfg)(state, *tiny_batch(4))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert cuda_kernels.fused_dropout.launches == 9
    assert cuda_kernels.fused_ode_solve.launches == 0


def eval_forward(model_type, solver_fields):
    """A tiny model's eval forward on the card (kernels on) with the launch
    counts set to 0 just before; returns (poses, K1, K2 launches)."""
    from ode_vio_tpu_torch.config import Config, ModelConfig, SolverConfig
    from ode_vio_tpu_torch.models.deepvio import create_model

    solver = SolverConfig(**solver_fields)
    cfg = Config(model=ModelConfig(model_type=model_type, use_kernels=True, **TINY_TRAIN),
                 solver=solver, cde_solver_cfg=solver)
    model = create_model(cfg, seed=0)
    img, imu, _, ts = tiny_batch(4)
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        poses = model(img, imu, ts)[0]
    return poses, cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_cde_solve.launches


@pytest.mark.gpu
def test_fixed_step_eval_launches_no_k1_on_gpu():
    """A tiny ode-rnn eval forward with fixed steps on the card, kernels
    on: no K1 launch (K1 is adaptive only), finite poses; the adaptive
    forward launches K1 once per frame interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    poses, k1, k2 = eval_forward("ode-rnn", dict(adaptive=False))
    assert torch.isfinite(poses).all() and (k1, k2) == (0, 0)
    _, k1, _ = eval_forward("ode-rnn", {})
    assert k1 == 3


@pytest.mark.gpu
def test_adams_cde_eval_launches_no_k2_on_gpu():
    """A tiny cde eval forward with implicit_adams on the card, kernels on:
    no K2 launch, finite poses; the adaptive forward launches K2 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    poses, k1, k2 = eval_forward("cde", dict(method="implicit_adams"))
    assert torch.isfinite(poses).all() and (k1, k2) == (0, 0)
    _, _, k2 = eval_forward("cde", dict(rtol=1e-4))
    assert k2 == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["conv1", "conv2", "conv3", "conv3_1", "conv6"])
def test_int8_route_matches_plain_on_gpu(name):
    """The int8 trunk conv's card route (int8 im2col, torch._int_mm) at the
    block's shapes for 2 frame pairs at 64x128 (M past 16 rows, conv1's K
    padded from 294 to 296): its int32 sums equal the plain version's bit
    for bit, and the route launched once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm runs on the card")
    from ode_vio_tpu_torch.models import encoders

    spec = dict(zip(encoders.TRUNK_NAMES, encoders.TRUNK))
    c_in = dict(zip(encoders.TRUNK_NAMES, (6, 64, 128, 256, 256, 512, 512, 512, 512)))
    c_out, k, stride, _ = spec[name]
    hw = {"conv1": 64, "conv2": 32, "conv3": 16, "conv3_1": 8, "conv6": 2}[name]
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(2, c_in[name], hw, 2 * hw, generator=gen, device="cuda")
    w = 0.05 * torch.randn(c_out, c_in[name], k, k, generator=gen, device="cuda")
    xq, _ = encoders.quantize_activation(x)
    kq, _ = encoders.quantize_weight(w)
    before = encoders.int8_accumulate.launches
    got = encoders.int8_accumulate(xq, kq, stride, (k - 1) // 2)
    torch.cuda.synchronize()
    assert encoders.int8_accumulate.launches == before + 1
    want = encoders.int8_accumulate_plain(xq, kq, stride, (k - 1) // 2)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
def test_int8_and_s2d_encoders_on_gpu():
    """The tiny image encoder on the card (float32, TF32 off): with s2d
    within 1e-4 of the direct convs; with int8 (kernels on) 9 int8 GEMMs
    and features equal to the plain int8 route's (use_kernels=False) bit
    for bit, and close to the float features (correlation > 0.99)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm runs on the card")
    import dataclasses

    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models import encoders
    from ode_vio_tpu_torch.models.deepvio import create_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(model=ModelConfig(**TINY_TRAIN))
    sd = create_model(cfg, seed=0).Image_net.state_dict()
    img = tiny_batch(4)[0]

    def features(**fields):
        net = encoders.ImageEncoder(dataclasses.replace(cfg.model, **fields)).cuda().eval()
        net.load_state_dict(sd)
        with torch.no_grad():
            return net(img)

    direct = features()
    torch.testing.assert_close(features(encoder_s2d=True), direct, rtol=0, atol=1e-4)
    before = encoders.int8_accumulate.launches
    int8 = features(encoder_int8=True, use_kernels=True)
    assert encoders.int8_accumulate.launches == before + 9
    assert torch.equal(int8, features(encoder_int8=True, use_kernels=False))
    assert np.corrcoef(int8.cpu().numpy().ravel(), direct.cpu().numpy().ravel())[0, 1] > 0.99


@pytest.mark.gpu
def test_export_round_trip_on_gpu(tmp_path):
    """A checkpoint of a model on the card through cli.export (.pth): the
    file reloads into a model on the card whose state equals the
    original's, and the key set has no num_batches_tracked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ode_vio_tpu_torch.cli.export import main as export_main
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.convert import load_pretrain
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
    from ode_vio_tpu_torch.training.loop import create_train_state

    cfg = Config(model=ModelConfig(**TINY_TRAIN))
    model = create_model(cfg, seed=4)
    CheckpointManager(tmp_path / "ckpt").save("epoch_000", create_train_state(cfg, model))
    flags = [a for k, v in TINY_TRAIN.items() for a in (f"--{k}", str(v))]
    sd = export_main([*flags, "--pretrain", str(tmp_path / "ckpt"),
                      "--out", str(tmp_path / "m.pth")])
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    back = create_model(cfg, seed=5)
    load_pretrain(back, tmp_path / "m.pth")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.gpu
def test_trace_holds_cuda_kernels_on_gpu(tmp_path):
    """utils/profiling.py::trace around a conv and K3 on the card: the
    trace JSON holds CUDA kernel events, K3's among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    import torch.nn.functional as F

    from ode_vio_tpu_torch.utils.profiling import trace

    x = torch.randn(4, 6, 64, 128, device="cuda")
    w = torch.randn(64, 6, 7, 7, device="cuda")
    with trace(tmp_path):
        y = F.conv2d(x, w, stride=2, padding=3)
        cuda_kernels.fused_dropout(y.contiguous(), 7, 0.2)
        torch.cuda.synchronize()
    (path,) = list(tmp_path.glob("trace_*.json"))
    kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert kernels and any("fused_dropout" in n for n in kernels)


@pytest.mark.gpu
def test_debug_nans_raises_on_gpu():
    """A NaN in one IMU sample of a tiny model's forward on the card raises
    FloatingPointError under the trap, and not without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.utils.profiling import debug_nans

    model = create_model(Config(model=ModelConfig(**TINY_TRAIN)), seed=0)
    img, imu, _, ts = tiny_batch(4)
    imu[0, 5, 1] = float("nan")
    with torch.no_grad():
        model(img, imu, ts)
        with debug_nans(), pytest.raises(FloatingPointError):
            model(img, imu, ts)


@pytest.fixture
def no_tf32():
    """float32 matmuls and convs in float32, as chip_smoke.py's env() sets
    them (cuDNN takes TF32 by default): the mesh cases compare float32
    runs at other batch sizes."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.gpu
def test_two_ranks_share_the_card_on_gpu(no_tf32):
    """chip_smoke.train_mesh at tiny widths: two ranks on cuda:0 over gloo,
    2 steps at B=4 global: K3 9 a step on each rank, the ranks' states bit
    for bit equal after every step, their keys different, the float32
    step's loss and gradient norm within 1e-4 of one process's (train_mesh
    raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from ode_vio_tpu_torch.config import Config, ModelConfig, TrainConfig

    cfg = Config(model=ModelConfig(**TINY_TRAIN),
                 train=TrainConfig(batch_size=4, freeze_encoder=True))
    out = chip_smoke.train_mesh(torch.device("cuda", 0), cfg, 2, k3_per_step=9)
    assert out["k3"] == 2 * 2 * 9
    parity = out["report"]["parity_float32"]
    assert parity["loss_rel"] <= chip_smoke.MESH_STEP_RTOL
    assert parity["grad_norm_rel"] <= chip_smoke.MESH_STEP_RTOL


@pytest.mark.gpu
def test_engine_replicas_share_the_card_on_gpu(no_tf32):
    """chip_smoke.serve_mesh at tiny widths (seq_len 11, float32): 4
    sessions over two replicas on cuda:0 against one engine: K1 10 a step
    per replica, every session within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from ode_vio_tpu_torch.config import Config, ModelConfig

    dev = torch.device("cuda", 0)
    cfg = Config(model=ModelConfig(**dict(TINY_TRAIN, seq_len=11)))
    launches, gap, _, _ = chip_smoke.serve_mesh(dev, cfg, [dev, dev])
    assert launches == len(chip_smoke.SCHEDULE) * 10 * 2
    assert gap <= chip_smoke.MESH_POSE_ATOL["float32"]


@pytest.mark.gpu
def test_eval_lanes_split_on_gpu(tmp_path, no_tf32):
    """chip_smoke.eval_lanes at tiny widths on a tiny tree: 2 runs of two
    sequences (4 lanes) over two replicas on cuda:0 against one device:
    K1 3 a window step per replica (seq_len 4), each lane within 1e-5
    (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from ode_vio_tpu_torch.config import Config, DataConfig, ModelConfig
    from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
    from ode_vio_tpu_torch.models.deepvio import create_model

    dev = torch.device("cuda", 0)
    root = make_kitti_tree(tmp_path / "kitti", seqs=("05", "07"), n_frames=24,
                           img_hw=(32, 64), speed_scale=50.0)
    cfg = Config(model=ModelConfig(**TINY_TRAIN), data=DataConfig(eval_data_dropout=0.3))
    model = create_model(cfg, seed=0, device=dev)
    one = chip_smoke.eval_lanes(model, root, cfg, dev, None, ("05", "07"), k1_per_step=3)
    split = chip_smoke.eval_lanes(model, root, cfg, dev, [dev, dev], ("05", "07"),
                                  k1_per_step=3)
    assert split["k1"] == 2 * one["k1"]
    assert chip_smoke.lane_gap(one["poses"], split["poses"]) <= 1e-5


@pytest.mark.gpu
def test_cde_eval_lanes_split_on_gpu(tmp_path, no_tf32):
    """chip_smoke.eval_lanes with the cde core at tiny widths: 2 runs of
    sequence 05 over two replicas on cuda:0 (a lane each, K2 once a
    window step per replica) against each run unsplit in a call of its
    own, which is what a replica computes: each lane within 1e-5
    (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from ode_vio_tpu_torch.config import Config, DataConfig, ModelConfig
    from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
    from ode_vio_tpu_torch.models.deepvio import create_model

    dev = torch.device("cuda", 0)
    root = make_kitti_tree(tmp_path / "kitti", seqs=("05",), n_frames=24,
                           img_hw=(32, 64), speed_scale=50.0)
    cfg = Config(model=ModelConfig(**dict(TINY_TRAIN, model_type="cde")),
                 data=DataConfig(eval_data_dropout=0.3))
    model = create_model(cfg, seed=0, device=dev)
    alone = [chip_smoke.eval_lanes(model, root, cfg, dev, None, ("05",), k2_per_step=1,
                                   runs=(run,)) for run in range(2)]
    split = chip_smoke.eval_lanes(model, root, cfg, dev, [dev, dev], ("05",), k2_per_step=1)
    assert split["k2"] == sum(a["k2"] for a in alone) > 0
    assert chip_smoke.lane_gap([p for a in alone for p in a["poses"]], split["poses"]) <= 1e-5


@pytest.mark.gpu
def test_entry_forward_launches_k1_on_gpu(no_tf32):
    """entry.build_forward at tiny widths (seq_len 11, float32) on the card:
    K1 once a frame interval of the window (10), finite poses within 1e-3
    of the same weights through the solver core (use_kernels=False)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.entry import build_forward

    cfg = Config(model=ModelConfig(**dict(TINY_TRAIN, seq_len=11)))
    fn, args = build_forward(cfg, device="cuda")
    before = cuda_kernels.fused_ode_solve.launches
    poses = fn(*args)
    assert cuda_kernels.fused_ode_solve.launches - before == 10
    core = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_kernels=False))
    ref_fn, _ = build_forward(core, device="cuda")
    ref_fn.model.load_state_dict(fn.model.state_dict())
    ref = ref_fn(*args)
    assert poses.shape == (1, 10, 6) and torch.isfinite(poses).all()
    assert float((poses - ref).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_dryrun_multichip_splits_on_gpu(capsys):
    """dryrun_multichip(4) with its four ranks on cuda:0 over gloo: a
    (2, 2) mesh, JAX's ok line, every rank the same finite losses, K3 18 a
    step on each rank, and each rank storing half of every split weight
    (its parameters the unsplit model's less half of the split ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ode_vio_tpu_torch.entry import dryrun_config, dryrun_multichip
    from ode_vio_tpu_torch.models.deepvio import DeepVIO

    ranks = dryrun_multichip(4, "cuda")
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "dryrun_multichip ok: mesh={'data': 2, 'model': 2} loss=")
    cfg, _ = dryrun_config(4)
    with torch.device("meta"):
        whole = sum(p.numel() * p.element_size() for p in DeepVIO(cfg.model).parameters())
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert all(np.isfinite(m["loss"]) for m in r["metrics"])
        assert r["launches"]["fused_dropout"] == 2 * 18
        b = r["stored_bytes"]
        assert b["params_split"] > 0 and b["params"] + b["params_split"] == whole
        assert {n: s for n, s in r["shapes"].items() if s != ranks[0]["shapes"][n]} == {}
    assert ranks[0]["shapes"]["Image_net.visual_head.weight"] == (64, 2048)
