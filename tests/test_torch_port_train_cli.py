"""The port's training command line on the CPU: ``cli.train --device
cpu`` against the JAX package's ``cli.train``, both warm-started from one
reference-layout ``.npz`` (JAX's ``export_deepvio``) with the frozen image
encoder's inference graph (no dropout: the frameworks' random bits
differ); its checkpoints (a bitwise save/restore round trip, a run
resumed at an epoch boundary equal to the run that did not stop); cde and
rde epochs; the port's checkpoints as ``--pretrain`` of ``cli.test``;
``--pretrain_flownet`` against JAX's ``convert_image_encoder``; and the
refusals that remain (item 5c, JAX Orbax directories).

Tolerances: the logged per-epoch losses (six decimals) within rtol 1e-4,
as the train step's own parity holds them (tests/test_torch_port_train.py);
eval t_rel / r_rel within rtol 1e-3, as tests/test_torch_port_cli.py holds
``cli.test``'s summary means (r_rel at random init sums rotations of
nearly opposite sign: measured 2.7e-4)."""

import re
import sys

import jax
import numpy as np
import pytest
import torch

from ode_vio_tpu.cli.flags import build_parser as jax_build_parser
from ode_vio_tpu.cli.flags import config_from_args as jax_config_from_args
from ode_vio_tpu.cli.train import _warm_start_epoch as jax_warm_start_epoch
from ode_vio_tpu.cli.train import main as jax_train_main
from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.models.convert import convert_image_encoder, export_deepvio, trunk_out_hw
from ode_vio_tpu.models.deepvio import init_model
from ode_vio_tpu_torch.cli.test import main as cli_test_main
from ode_vio_tpu_torch.cli.train import _warm_start_epoch, main as train_main
from ode_vio_tpu_torch.config import Config, ModelConfig, TrainConfig
from ode_vio_tpu_torch.models.convert import from_jax_variables, load_flownet
from ode_vio_tpu_torch.models.deepvio import create_model
from ode_vio_tpu_torch.models.encoders import TRUNK, TRUNK_NAMES
from ode_vio_tpu_torch.training import loop as tloop
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager

from torch_port_helpers import one_torch_thread, randomize_batchnorm  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
IMG_H, IMG_W = 32, 64
# tests/test_cli.py's TINY_FLAGS on the sequences of this file's tree
TINY_FLAGS = [
    "--img_w", str(IMG_W), "--img_h", str(IMG_H), "--seq_len", "4",
    "--v_f_len", "32", "--i_f_len", "16", "--ode_hidden_dim", "16",
    "--rnn_num_layers", "2", "--ode_max_steps", "8",
    "--compute_dtype", "float32", "--batch_size", "4",
    "--train_seq", "05", "--val_seq", "07",
    "--epochs_warmup", "1", "--epochs_joint", "0", "--epochs_fine", "0",
    "--workers", "0", "--print_frequency", "2",
]
CDE_FLAGS = ["--cde_hidden_dim", "8", "--cde_fn_num_layers", "2", "--rde_reduced_dim", "4"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two 24-frame sequences at ~5 m per frame (t_rel finite)."""
    base = tmp_path_factory.mktemp("train_cli")
    root = make_kitti_tree(base / "kitti", seqs=("05", "07"), n_frames=24,
                           img_hw=(IMG_H, IMG_W), speed_scale=50.0)
    return base, root


def logged(log_dir, pattern):
    """Every match of ``pattern``'s groups in the run's log, as floats."""
    text = next(log_dir.glob("*.log")).read_text()
    return [tuple(float(x) for x in m.groups()) for m in re.finditer(pattern, text)]


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX init of the TINY_FLAGS model."""
    jc = jax_config_from_args(jax_build_parser().parse_args(TINY_FLAGS))
    return init_model(jc, jax.random.PRNGKey(0))[1]


def test_cli_train_matches_jax(tree, jax_variables):
    """Two epochs of ``cli.train`` in both packages from one warm start
    (with frame dropout in the loader): per-epoch losses and eval t_rel /
    r_rel within rtol 1e-3, and an epoch checkpoint each."""
    base, root = tree
    flags = [*TINY_FLAGS, "--epochs_warmup", "2", "--freeze_encoder", "--frozen_encoder_eval",
             "--data_dropout", "0.2"]
    npz = base / "warm.npz"
    np.savez(npz, **export_deepvio(randomize_batchnorm(jax_variables), "ode-rnn",
                                   trunk_out_hw(IMG_H, IMG_W)))
    common = ["--data_dir", str(root), "--save_dir", str(base / "results"),
              "--pretrain", str(npz), *flags]
    jax_train_main(["--experiment_name", "jax", *common])
    timing = {}
    train_main(["--experiment_name", "port", "--device", "cpu", *common], timing=timing)
    losses, evals = r"done: loss ([\d.]+)", r"eval: t_rel ([\d.]+) r_rel ([\d.]+)"
    ref_l, ref_e = (logged(base / "results/jax/logs", p) for p in (losses, evals))
    got_l, got_e = (logged(base / "results/port/logs", p) for p in (losses, evals))
    assert len(ref_l) == len(got_l) == 2 and len(ref_e) == len(got_e) == 2
    assert np.isfinite(ref_e).all()
    np.testing.assert_allclose(got_l, ref_l, rtol=1e-4)
    np.testing.assert_allclose(got_e, ref_e, rtol=1e-3)
    assert (base / "results/port/checkpoints/epoch_000/state.pt").exists()
    epochs = timing["epochs"]
    assert [e["epoch"] for e in epochs] == [0, 1]
    # the same batches: JAX logs its loader's length
    ref_steps = dict(logged(base / "results/jax/logs", r"epoch (\d+) iter \d+/(\d+)"))
    assert [len(e["steps"]) for e in epochs] == [ref_steps[0], ref_steps[1]]
    np.testing.assert_allclose([e["loss"] for e in epochs], np.ravel(got_l), rtol=1e-5)


def state_parts(state):
    """Everything a checkpoint holds, as CPU values."""
    opt = state.optimizer.state_dict()
    return {"model": state.model.state_dict(), "inner": opt["inner"],
            "mini_step": opt["mini_step"], "mean": opt["mean"], "step": state.step,
            "generator": state.generator.get_state()}


def assert_same(a, b, path="state"):
    """Bitwise equality of nested dicts, lists and tensors."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def tiny_state(cfg, seed=1):
    model = create_model(cfg, seed=0, device="cpu", train=True)
    return tloop.create_train_state(cfg, model, seed=seed, device="cpu")


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Three steps with gradient accumulation over 2 (Adam's moments and
    step, a half-full accumulation mean, the generator moved by K3's
    plain-version dropout keys), saved and restored into a fresh state:
    every part bit for bit, and the next step of both bit for bit."""
    cfg = Config(model=ModelConfig(img_h=IMG_H, img_w=IMG_W, seq_len=3, v_f_len=32,
                                   i_f_len=16, ode_hidden_dim=16, compute_dtype="float32"),
                 train=TrainConfig(batch_size=2, freeze_encoder=True, grad_accumulation_steps=2))
    rng = np.random.default_rng(0)
    batches = [(rng.random((2, 3, IMG_H, IMG_W, 3), np.float32) - 0.5,
                rng.standard_normal((2, 21, 6)).astype(np.float32),
                (0.1 * rng.standard_normal((2, 2, 6))).astype(np.float32),
                np.cumsum(rng.uniform(0.08, 0.13, (2, 3)), 1).astype(np.float32))
               for _ in range(4)]
    step = tloop.make_train_step(cfg, device="cpu")
    state = tiny_state(cfg)
    for b in batches[:3]:
        state, _ = step(state, *b)
    assert state.optimizer.mini_step == 1 and state.optimizer.state_dict()["mean"] is not None
    ckpt = CheckpointManager(tmp_path / "ckpt")
    ckpt.save(ckpt.epoch_name(3), state, {"epoch": 3, "best_t_rel": float("inf")})
    assert ckpt.latest_epoch() == 3 and ckpt.metadata("epoch_003")["epoch"] == 3
    fresh = ckpt.restore("epoch_003", tiny_state(cfg, seed=5))
    assert_same(state_parts(fresh), state_parts(state))
    _, m1 = step(state, *batches[3])
    _, m2 = step(fresh, *batches[3])
    assert torch.equal(m1["loss"], m2["loss"])
    assert_same(state_parts(fresh), state_parts(state))


def test_split_run_equals_continuous_run(tree):
    """Epochs 0-1 in one run against epoch 0, then a run resumed from its
    checkpoints directory for epoch 1 (tests/test_cli.py's protocol
    without the mesh; trunk dropout through K3's plain version, so the
    generator's state matters): epoch_001 equal bit for bit, and the split
    run's epoch_000 metadata carried into its epoch_001."""
    base, root = tree
    flags = ["--data_dir", str(root), *TINY_FLAGS, "--freeze_encoder", "--ckpt_every", "1",
             "--device", "cpu"]
    cont, split = base / "cont", base / "split"
    train_main(["--save_dir", str(cont), "--experiment_name", "run", *flags,
                "--epochs_warmup", "2"])
    train_main(["--save_dir", str(split), "--experiment_name", "run", *flags])
    ckpt_split = split / "run" / "checkpoints"
    train_main(["--save_dir", str(split), "--experiment_name", "run", *flags,
                "--epochs_warmup", "2", "--pretrain", str(ckpt_split)])
    a = CheckpointManager(cont / "run" / "checkpoints")
    b = CheckpointManager(ckpt_split)
    assert_same(b.restore_raw("epoch_001"), a.restore_raw("epoch_001"))
    # as in JAX, an epoch's checkpoint is written before its evaluation, so
    # epoch_000 holds the best before epoch 0's t_rel
    assert b.metadata("epoch_001") == {"epoch": 1, **{
        k: v for k, v in b.metadata("epoch_000").items() if k != "epoch"}}
    assert [p.name for p in ckpt_split.glob("best_*.meta.json")]


@pytest.mark.parametrize("model_type", ["cde", "rde"])
def test_cli_train_cde_rde_then_test(tree, model_type, monkeypatch, caplog):
    """One epoch of the cde or rde core with ``--wandb`` where wandb cannot
    be imported (one warning, training goes on), the trunk from a
    synthetic FlowNet-S file; then ``cli.test`` on its checkpoints
    directory."""
    base, root = tree
    flownet = base / f"flownet_{model_type}.pth"
    torch.save(flownet_state_dict(seed=3), flownet)
    monkeypatch.setitem(sys.modules, "wandb", None)
    save = base / "results_cde"
    common = ["--data_dir", str(root), "--save_dir", str(save), "--device", "cpu",
              *TINY_FLAGS, *CDE_FLAGS, "--model_type", model_type]
    timing = {}
    train_main(["--experiment_name", model_type, *common, "--freeze_encoder", "--wandb",
                "--pretrain_flownet", str(flownet)], timing=timing)
    (epoch,) = timing["epochs"]
    assert np.isfinite(epoch["loss"]) and np.isfinite(epoch["t_rel"])
    assert all(np.isfinite(s["loss"]) and s["solver_incomplete"] >= 0 for s in epoch["steps"])
    warnings = [r for r in caplog.records if "wandb unavailable" in r.getMessage()]
    assert len(warnings) == 1 and warnings[0].levelname == "WARNING"
    ckpt = save / model_type / "checkpoints"
    raw = CheckpointManager(ckpt).restore_raw("epoch_000")
    ref = flownet_state_dict(seed=3)
    assert torch.equal(raw["model"]["Image_net.conv2.0.weight"], ref["conv2.0.weight"])
    cli_test_main(["--experiment_name", model_type, *common, "--pretrain", str(ckpt)])
    assert "seq 07" in (save / f"{model_type}_test" / "summary.txt").read_text()


def flownet_state_dict(seed, head_hw=None, v_f_len=32):
    """A synthetic FlowNet-S state_dict: the trunk's conv weights (no
    bias) and BatchNorms under the FlowNet-S names, the decoder's keys the
    port ignores, and with ``head_hw`` a ``visual_head`` for that trunk
    output."""
    g = torch.Generator().manual_seed(seed)
    sd, c_in = {}, 6
    for name, (c_out, k, _, _) in zip(TRUNK_NAMES, TRUNK):
        sd[f"{name}.0.weight"] = 0.1 * torch.randn(c_out, c_in, k, k, generator=g)
        sd[f"{name}.1.weight"] = 1 + 0.1 * torch.randn(c_out, generator=g)
        sd[f"{name}.1.bias"] = 0.1 * torch.randn(c_out, generator=g)
        sd[f"{name}.1.running_mean"] = 0.1 * torch.randn(c_out, generator=g)
        sd[f"{name}.1.running_var"] = 0.5 + torch.rand(c_out, generator=g)
        sd[f"{name}.1.num_batches_tracked"] = torch.tensor(7)
        c_in = c_out
    sd["deconv5.0.weight"] = torch.randn(1024, 512, 4, 4, generator=g)
    sd["predict_flow6.weight"] = torch.randn(2, 1024, 3, 3, generator=g)
    if head_hw is not None:
        n = c_in * head_hw[0] * head_hw[1]
        sd["visual_head.weight"] = torch.randn(v_f_len, n, generator=g) / n ** 0.5
        sd["visual_head.bias"] = 0.1 * torch.randn(v_f_len, generator=g)
    return sd


@pytest.mark.parametrize("head", [False, True])
def test_pretrain_flownet_matches_jax(tmp_path, jax_variables, head):
    """``load_flownet`` against JAX's ``convert_image_encoder`` merged into
    the init as JAX's ``cli.train`` merges it: the port's Image_net equals
    the bridged result bit for bit, every other weight stays the init's."""
    variables = jax_variables
    hw = trunk_out_hw(IMG_H, IMG_W)
    sd = flownet_state_dict(seed=1, head_hw=hw if head else None)
    path = tmp_path / "flownet.pth"
    torch.save({"state_dict": sd}, path)
    p, s = convert_image_encoder({k: v.numpy() for k, v in sd.items()}, conv_out_hw=hw)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    params["image_encoder"] = {**params["image_encoder"], **p}
    stats["image_encoder"] = {**stats["image_encoder"], **{
        k: {**stats["image_encoder"].get(k, {}), **v} for k, v in s.items()}}
    tc = Config(model=ModelConfig(img_h=IMG_H, img_w=IMG_W, seq_len=4, v_f_len=32, i_f_len=16,
                                  ode_hidden_dim=16, compute_dtype="float32"))
    want = from_jax_variables({"params": params, "batch_stats": stats}, tc.model)
    init = from_jax_variables(variables, tc.model)
    model = create_model(tc, device="cpu")
    model.load_state_dict(init)
    keys = load_flownet(model, path)
    assert len(keys) == 5 * len(TRUNK_NAMES) + (2 if head else 0)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
        changed = not torch.equal(v, init[k])
        assert changed == (k[len("Image_net."):] in keys), k


@pytest.mark.parametrize("name", ["007.pth", "runs/042.npz", "ode-vio-v1.pth", "1234.pth",
                                  "model.pth", "epoch_003"])
def test_warm_start_epoch_matches_jax(name):
    assert _warm_start_epoch(name) == jax_warm_start_epoch(name)


def test_orbax_directory_exits_with_hint(tree):
    """A JAX package's checkpoints directory (Orbax epoch directories, no
    port checkpoint in them) exits naming cli.export, in cli.test and as
    the resume of cli.train."""
    base, root = tree
    orbax = base / "orbax" / "checkpoints"
    (orbax / "epoch_000").mkdir(parents=True)
    (orbax / "epoch_000" / "_METADATA").write_text("{}")
    common = ["--data_dir", str(root), "--save_dir", str(base / "results_orbax"),
              "--device", "cpu", *TINY_FLAGS, "--pretrain", str(orbax)]
    for main in (cli_test_main, train_main):
        with pytest.raises(SystemExit, match=r"directory.*epoch_000.*cli\.export"):
            main(["--experiment_name", "orbax", *common])


@pytest.mark.parametrize("flag", [["--tbptt_chain", "2"], ["--carry_exposure", "0.5"],
                                  ["--carry_split", "3"]])
def test_item_5c_flags_exit(tree, flag):
    base, root = tree
    with pytest.raises(SystemExit, match=r"Queue 1 item 5c"):
        train_main(["--data_dir", str(root), "--save_dir", str(base / "r5c"), "--device", "cpu",
                    *TINY_FLAGS, *flag])
