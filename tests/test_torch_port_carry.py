"""The carried train step and full-sequence TBPTT of the port against the
JAX package at tiny widths (32x64 images, seq_len 5, features 32/16, ODE
hidden 16, CDE hidden 8 with 2 field layers, rde reduced to 4 channels,
float32 compute, soft fusion): ``make_train_step(carry=True)``,
``make_streaming_train_step`` cold and carried, the detached carry, the
configuration's and the split's errors, ``cli.train``'s exposure draws and
TBPTT batches, and how its epoch loop threads the carry.

No dropout runs anywhere (the frozen image encoder's inference graph,
``rnn_dropout_out`` 0): the frameworks' random bits differ. Tolerances as
tests/test_torch_port_train_cde.py holds the fresh step: ode-rnn and rde
metrics at rtol 1e-5 with Adam, params by ``compare_state``; cde at rtol
2e-3 with SGD and a step budget that truncates no solve (rounding decides
the tiny cde field's step sequence). The windows' clock starts at 5 s, so
the carried segment's ``ts[:, k]`` is far from 0: the cde core rebases it
in train mode, the ode-rnn core runs on it, in both packages."""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu import config as jcfg
from ode_vio_tpu.cli.flags import build_parser as jax_build_parser
from ode_vio_tpu.cli.flags import config_from_args as jax_config_from_args
from ode_vio_tpu.cli.train import _exposure_step as jax_exposure_step
from ode_vio_tpu.cli.train import get_train_loader as jax_get_train_loader
from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.models.convert import convert_deepvio, trunk_out_hw
from ode_vio_tpu.models.deepvio import create_model as jax_create_model
from ode_vio_tpu.models.pose_cde import PoseCDE as JaxPoseCDE
from ode_vio_tpu.models.pose_rde import PoseRDE as JaxPoseRDE
from ode_vio_tpu.training import loop as jloop
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.cli.train import _exposure_step, get_train_loader
from ode_vio_tpu_torch.cli import train as train_module
from ode_vio_tpu_torch.cli.train import main as train_main
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO, create_model
from ode_vio_tpu_torch.training import loop as tloop

from test_torch_port_train import compare_state, recording
from torch_port_helpers import one_torch_thread, randomize_batchnorm  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, S, H, W = 4, 5, 32, 64
T0 = 5.0
TINY = dict(img_w=W, img_h=H, seq_len=S, v_f_len=32, i_f_len=16, ode_hidden_dim=16,
            rnn_num_layers=2, ode_activation_fn="softplus", ode_fn_num_layers=2,
            cde_hidden_dim=8, cde_fn_num_layers=2, rde_reduced_dim=4, fuse_method="soft",
            compute_dtype="float32")
METRIC_RTOL = {"ode-rnn": 1e-5, "rde": 1e-5, "cde": 2e-3}
# cde with SGD: Adam's sign-like step parts the frameworks by 2 lr where
# rounding flips a small gradient (tests/test_torch_port_train_cde.py)
CDE_TRAIN = dict(optimizer="sgd", lr_warmup=1e-2)
STEPS_TRAIN = {"ode-rnn": 16, "cde": 128, "rde": 16}


def configs(model_type, **train):
    model = dict(TINY, model_type=model_type)
    train = dict(batch_size=B, freeze_encoder=True, frozen_encoder_eval=True,
                 **(CDE_TRAIN if model_type == "cde" else {}), **train)
    cde = dict(rtol=1e-4, atol=1e-6, max_steps=256, max_steps_train=STEPS_TRAIN.get(model_type, 16))
    return (jcfg.Config(model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(seq_len=S),
                        train=jcfg.TrainConfig(**train), cde_solver_cfg=jcfg.SolverConfig(**cde)),
            tcfg.Config(model=tcfg.ModelConfig(**model), train=tcfg.TrainConfig(**train),
                        cde_solver_cfg=tcfg.SolverConfig(**cde)))


def train_batch(seed, t0=T0):
    rng = np.random.default_rng(seed)
    return (rng.random((B, S, H, W, 3), np.float32) - 0.5,
            rng.standard_normal((B, 10 * (S - 1) + 1, 6)).astype(np.float32),
            (0.1 * rng.standard_normal((B, S - 1, 6))).astype(np.float32),
            (t0 + np.cumsum(rng.uniform(0.08, 0.13, (B, S)), 1)).astype(np.float32))


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_state(jc, v):
    tx = jloop.make_optimizer(jc)
    return tx, jloop.create_train_state(jc, jax.tree_util.tree_map(jnp.asarray, v), tx,
                                        jax.random.PRNGKey(1))


def port_state(tc, v):
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg)
    model.load_state_dict(from_jax_variables(v, tc.model), strict=True)
    return tloop.create_train_state(tc, model, device="cpu")


def check_metrics(m, ref, rtol):
    for k in ("loss", "angle_loss", "trans_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref[k]), rtol=rtol, err_msg=k)
    assert int(m["solver_incomplete"]) == int(ref["solver_incomplete"])


def variables(model_type):
    """JAX variables of the tiny ``model_type`` model, with random BatchNorm
    statistics: the port's seeded init read by JAX's ``convert_deepvio``
    (the encoders, the same for every core), with the cde/rde pose core
    from the JAX package's own init, the weights
    tests/test_torch_port_train_cde.py holds these cores on. (With the
    port's draw of the rde field, rounding decides its step sequence at
    rtol 1e-4: the fresh step's trans loss moves by 1e-5 relative.)"""
    _, tc = configs(model_type)
    sd = create_model(tc, seed=0, device="cpu").state_dict()
    v = randomize_batchnorm(convert_deepvio(
        {k: x.numpy() for k, x in sd.items()}, model_type,
        rnn_num_layers=TINY["rnn_num_layers"], conv_out_hw=trunk_out_hw(H, W)))
    if model_type in ("cde", "rde"):
        jc, _ = configs(model_type)
        core = (JaxPoseCDE if model_type == "cde" else JaxPoseRDE)(jc.model, jc.cde_solver_cfg)
        fv, fi = (np.zeros((B, S - 1, TINY[f]), np.float32) for f in ("v_f_len", "i_f_len"))
        init = jax.jit(lambda k: core.init(k, fv, fi, train_batch(9)[3]))
        v["params"]["pose_net"] = as_np(init(jax.random.PRNGKey(0))["params"])
    return v


# ---------------------------------------------------------------------------
# the carried step against JAX's make_train_step(carry=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["ode-rnn", "rde", "cde"])
def test_carried_step_matches_jax(model_type):
    """One carried step (split at k = 2): metrics within the core's rtol,
    truncated solves summed over both segments equal; params and every
    statistic (the inertial encoder's moved once per segment) by
    ``compare_state`` for ode-rnn and rde, and for cde each trained
    tensor's update within 2e-3 of its largest."""
    jc, tc = configs(model_type)
    v = variables(model_type)
    tx, jst = jax_state(jc, v)
    batch = train_batch(0)
    jst, ref = jloop.make_train_step(jax_create_model(jc), tx, jc, carry=True)(
        jst, *map(jnp.asarray, batch))
    state = port_state(tc, v)
    grads = recording(state)
    before = copy.deepcopy(state.model.state_dict())
    state, m = tloop.make_train_step(tc, carry=True, device="cpu")(state, *batch)
    check_metrics(m, ref, METRIC_RTOL[model_type])
    if model_type != "cde":
        compare_state(state.model, as_np(jst.params), as_np(jst.batch_stats), tc, grads)
        return
    want = from_jax_variables({"params": as_np(jst.params),
                               "batch_stats": as_np(jst.batch_stats)}, tc.model)
    for name, p in state.model.state_dict().items():
        got, ref_p, was = p.numpy(), want[name].numpy(), before[name].numpy()
        if name in grads[0]:
            step_ref = ref_p - was
            np.testing.assert_allclose(got - was, step_ref, rtol=0,
                                       atol=2e-3 * float(np.abs(step_ref).max()) + 1e-9,
                                       err_msg=name)
        elif not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got, ref_p, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("model_type,split", [("ode-rnn", 0), ("ode-rnn", 4), ("cde", 1),
                                              ("rde", 3), ("rnn", 4)])
def test_carry_split_out_of_range_raises_as_jax(model_type, split):
    """At seq_len 5 a segment needs 1 pose step (2 for cde/rde): JAX's
    ValueError, message for message. (ode-rnn's 0 is the midpoint and
    builds.)"""
    jc, tc = configs(model_type, carry_split=split)
    try:
        jloop.make_train_step(jax_create_model(jc), jloop.make_optimizer(jc), jc, carry=True)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tloop.make_train_step(tc, carry=True, device="cpu")
        assert str(got.value) == str(e)
    else:
        assert split == 0
        tloop.make_train_step(tc, carry=True, device="cpu")


@pytest.mark.parametrize("fields", [dict(carry_exposure=1.5), dict(carry_exposure=-0.1),
                                    dict(tbptt_chain=4, carry_exposure=0.2),
                                    dict(tbptt_chain=1)])
def test_train_config_errors_match_jax(fields):
    with pytest.raises(ValueError) as ref:
        jcfg.TrainConfig(**fields)
    with pytest.raises(ValueError) as got:
        tcfg.TrainConfig(**fields)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the streaming (TBPTT) step
# ---------------------------------------------------------------------------

def test_cold_streaming_step_equals_fresh_step():
    """``hc=None`` is the fresh step: the same metrics and params bit for
    bit from the same state, and the returned carry detached."""
    _, tc = configs("ode-rnn")
    v = variables("ode-rnn")
    a, b = port_state(tc, v), port_state(tc, v)
    batch = train_batch(1)
    _, ma = tloop.make_train_step(tc, device="cpu")(a, *batch)
    _, mb, hc = tloop.make_streaming_train_step(tc, device="cpu")(b, *batch)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert hc.shape == (TINY["rnn_num_layers"], B, 48)
    assert not hc.requires_grad and hc.grad_fn is None


def test_carried_streaming_step_matches_jax():
    """A chain of two on the rnn core: JAX's cold step, then JAX's carried
    step from its own h_T; the port's cold step, then its carried step
    from JAX's h_T (as a tensor). Both steps' metrics at rtol 1e-5, the
    port's own h_T close to JAX's, and params after the two steps by
    ``compare_state``."""
    jc, tc = configs("rnn")
    v = variables("rnn")
    tx, jst = jax_state(jc, v)
    jstep = jloop.make_streaming_train_step(jax_create_model(jc), tx, jc)
    b1, b2 = train_batch(2), train_batch(3, t0=T0 + 0.6)
    jst, ref1, jh = jstep(jst, *map(jnp.asarray, b1))
    jst, ref2, _ = jstep(jst, *map(jnp.asarray, b2), jh)
    state = port_state(tc, v)
    grads = recording(state)
    step = tloop.make_streaming_train_step(tc, device="cpu")
    state, m1, hc = step(state, *b1)
    np.testing.assert_allclose(hc.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    state, m2, _ = step(state, *b2, torch.tensor(np.asarray(jh)))
    check_metrics(m1, ref1, 1e-5)
    check_metrics(m2, ref2, 1e-5)
    compare_state(state.model, as_np(jst.params), as_np(jst.batch_stats), tc, grads)


def test_chained_step_gradient_stops_at_the_window():
    """The carry a streaming step returns is detached: the next step's
    gradients from it equal those from a ``.clone().detach()``ed copy, and
    neither reaches the previous window's graph."""
    _, tc = configs("ode-rnn")
    state = port_state(tc, variables("ode-rnn"))
    step = tloop.make_streaming_train_step(tc, device="cpu")
    state, _, hc = step(state, *train_batch(4))
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    ga, gb = recording(a), recording(b)
    batch = train_batch(5, t0=T0 + 0.6)
    _, ma, ha = step(a, *batch, hc)
    _, mb, hb = step(b, *batch, hc.clone().detach())
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ha, hb)
    for name in ga[0]:
        assert torch.equal(ga[0][name], gb[0][name]), name


# ---------------------------------------------------------------------------
# the command line: exposure draws, TBPTT batches, a TBPTT run
# ---------------------------------------------------------------------------

def test_exposure_step_draws_match_jax():
    """Which calls take the carried step, in 3 epochs of 12 steps, at
    exposure 0.3 and seed 7: the same choices as JAX's ``_exposure_step``."""
    seen = {}

    def record(pkg, kind):
        return lambda state, *batch: seen.setdefault(pkg, []).append(kind)

    for pkg, fn, cfg_mod in (("jax", jax_exposure_step, jcfg), ("port", _exposure_step, tcfg)):
        cfg = cfg_mod.Config(train=cfg_mod.TrainConfig(carry_exposure=0.3, seed=7))
        for epoch in range(3):
            step = fn(record(pkg, "fresh"), record(pkg, "carried"), cfg, epoch)
            for _ in range(12):
                step(None)
    assert seen["port"] == seen["jax"] and 0 < seen["jax"].count("carried") < 36


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two 24-frame sequences at ~5 m per frame (t_rel finite)."""
    base = tmp_path_factory.mktemp("carry_cli")
    return base, make_kitti_tree(base / "kitti", seqs=("05", "07"), n_frames=24,
                                 img_hw=(H, W), speed_scale=50.0)


FLAGS = ["--img_w", str(W), "--img_h", str(H), "--seq_len", str(S), "--v_f_len", "32",
         "--i_f_len", "16", "--ode_hidden_dim", "16", "--cde_hidden_dim", "8",
         "--cde_fn_num_layers", "2", "--rde_reduced_dim", "4", "--compute_dtype", "float32",
         "--fuse_method", "soft", "--ode_activation_fn", "softplus", "--ode_fn_num_layers", "2",
         "--rnn_num_layers", "2",
         "--batch_size", "4", "--train_seq", "05", "07", "--val_seq", "07",
         "--epochs_warmup", "1", "--epochs_joint", "0", "--epochs_fine", "0", "--workers", "0",
         "--print_frequency", "2", "--data_dropout", "0.1"]


@pytest.mark.parametrize("epoch", [0, 1])
def test_tbptt_loader_matches_jax(tree, epoch):
    """``get_train_loader`` under ``--tbptt_chain 2``: JAX's dataset windows
    and sampler index batches, chains in lockstep (lane b of consecutive
    batches one window apart)."""
    _, root = tree
    flags = ["--data_dir", str(root), *FLAGS, "--tbptt_chain", "2"]
    log = logging.getLogger("carry_loader")
    ref = jax_get_train_loader(jax_config_from_args(jax_build_parser().parse_args(flags)),
                               epoch, log)
    got = get_train_loader(config_from_args(build_parser().parse_args(flags)), epoch, log)
    assert got.ds.seq_num_windows == ref.ds.seq_num_windows
    batches = list(got.sampler)
    assert batches == list(ref.sampler) and len(got) == len(ref) == len(batches) > 0
    for first, second in zip(batches[::2], batches[1::2]):
        assert [j - i for i, j in zip(first, second)] == [S - 1] * len(first)


@pytest.mark.parametrize("mode", ["tbptt", "exposure"])
def test_cli_train_threads_the_carry(tree, mode, monkeypatch):
    """One epoch of ``cli.train`` on the rnn core. ``--tbptt_chain 2``: the
    streaming step gets no carry at every chain start and the previous
    step's own ``hc_out`` otherwise. ``--carry_exposure 0.5``: the carried
    step takes the calls that the epoch's draws (seed, epoch) give it."""
    base, root = tree
    calls = []
    if mode == "tbptt":
        build = train_module.make_streaming_train_step

        def recorded(*a, **k):
            step = build(*a, **k)

            def rec(state, *batch):
                out = step(state, *batch)
                calls.append((batch[-1], out[2]))
                return out

            return rec

        monkeypatch.setattr(train_module, "make_streaming_train_step", recorded)
        flag = ["--tbptt_chain", "2"]
    else:
        build = train_module.make_train_step

        def recorded(cfg, carry=False, **k):
            step = build(cfg, carry, **k)
            return lambda state, *batch: calls.append(carry) or step(state, *batch)

        monkeypatch.setattr(train_module, "make_train_step", recorded)
        flag = ["--carry_exposure", "0.5"]
    timing = {}
    train_main(["--experiment_name", mode, "--device", "cpu", "--data_dir", str(root),
                "--save_dir", str(base / "results"), *FLAGS, "--model_type", "rnn",
                "--freeze_encoder", "--ckpt_every", "5", *flag], timing=timing)
    (epoch,) = timing["epochs"]
    assert len(calls) == len(epoch["steps"]) >= 4
    assert all(np.isfinite(s["loss"]) for s in epoch["steps"])
    if mode == "tbptt":
        for i, (hc, _) in enumerate(calls):
            assert hc is None if i % 2 == 0 else hc is calls[i - 1][1]
    else:
        draws = _exposure_step(lambda *a: False, lambda *a: True,
                               config_from_args(build_parser().parse_args([*FLAGS, *flag])), 0)
        assert calls == [draws(None) for _ in calls] and any(calls) and not all(calls)
