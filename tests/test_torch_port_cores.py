"""The rnn, gru, cfc and ltc pose cores of the port against the JAX package
at tiny widths (32x64 images, seq_len 4, features 32/16, 2 RNN layers,
rnn_hidden_dim 24, float32 compute, soft fusion): the liquid cells, the
pose cores cold and carried, the reference-layout weight bridge both ways,
the serving engine's lanes, one train step of each family, and the
``cli.test`` / ``cli.serve`` command lines.

Tolerances. The cells and pose cores on the same inputs: rtol 1e-5, atol
1e-6 (float32 matmuls summed in another order). Whole models through the
encoders: the engine's poses at atol 1e-4, as tests/test_torch_port_slice.py
holds the ode-rnn engine. A train step (Adam, no dropout anywhere: the
frozen image encoder's inference graph, ``rnn_dropout_out`` 0): loss,
angle, trans and grad_norm at rtol 1e-5; params where their gradient
clears rounding and every statistic by ``compare_state`` (rtol 1e-4, atol
1e-6)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu import config as jcfg
from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.models.convert import convert_deepvio, export_deepvio, trunk_out_hw
from ode_vio_tpu.models.deepvio import create_model as jax_create_model
from ode_vio_tpu.models.pose_ncp import PoseNCP as JaxPoseNCP
from ode_vio_tpu.models.pose_rnn import PoseRNN as JaxPoseRNN
from ode_vio_tpu.ops import liquid as jliquid
from ode_vio_tpu.serving import StreamingEngine as JaxEngine
from ode_vio_tpu.training import loop as jloop
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.cli.serve import main as serve_main
from ode_vio_tpu_torch.cli.test import main as cli_test_main
from ode_vio_tpu_torch.models.convert import from_jax_variables, load_pretrain
from ode_vio_tpu_torch.models.deepvio import DeepVIO, create_model
from ode_vio_tpu_torch.ops import liquid
from ode_vio_tpu_torch.serving import StreamingEngine
from ode_vio_tpu_torch.training import loop as tloop

from test_torch_port_train import compare_state, recording
from torch_port_helpers import one_torch_thread, randomize_batchnorm  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, S, H, W = 3, 4, 32, 64
HIDDEN = 24
TINY = dict(img_w=W, img_h=H, seq_len=S, v_f_len=32, i_f_len=16, rnn_num_layers=2,
            rnn_hidden_dim=HIDDEN, fuse_method="soft", compute_dtype="float32")
# name -> the ModelConfig fields of that core
CORES = {"rnn": dict(model_type="rnn"), "gru": dict(model_type="rnn", ode_rnn_type="gru"),
         "cfc": dict(model_type="cfc"), "ltc": dict(model_type="ltc")}


def t(x):
    return torch.tensor(np.asarray(x))


def configs(core, **train):
    model = dict(TINY, **CORES[core])
    return (jcfg.Config(model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(seq_len=S),
                        train=jcfg.TrainConfig(batch_size=B, **train)),
            tcfg.Config(model=tcfg.ModelConfig(**model),
                        train=tcfg.TrainConfig(batch_size=B, **train)))


@pytest.fixture(scope="module")
def encoders():
    """The tiny model's JAX variables with random BatchNorm statistics: the
    port's seeded init read by JAX's ``convert_deepvio`` (no JAX compile).
    The cores share its encoders."""
    _, tc = configs("rnn")
    sd = create_model(tc, seed=0, device="cpu").state_dict()
    return randomize_batchnorm(convert_deepvio({k: v.numpy() for k, v in sd.items()}, "rnn",
                                               rnn_num_layers=2, conv_out_hw=trunk_out_hw(H, W)))


def variables(encoders, jc):
    """``encoders`` with the pose core of ``jc`` initialised by JAX."""
    pose = jax_pose_core(jc).init(jax.random.PRNGKey(1), *features(9))["params"]
    params = dict(encoders["params"], pose_net=jax.tree_util.tree_map(np.asarray, pose))
    return {"params": params, "batch_stats": encoders["batch_stats"]}


def port_model(tc, v):
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg)
    model.load_state_dict(from_jax_variables(v, tc.model), strict=True)
    return model


def features(seed, t0=0.0):
    """Visual and inertial features and times of B lanes, as the pose
    cores take them."""
    rng = np.random.default_rng(seed)
    fv = rng.standard_normal((B, S - 1, TINY["v_f_len"])).astype(np.float32)
    fi = rng.standard_normal((B, S - 1, TINY["i_f_len"])).astype(np.float32)
    ts = (t0 + np.cumsum(rng.uniform(0.08, 0.13, (B, S)), 1)).astype(np.float32)
    return fv, fi, ts


def window(seed, t0=0.0):
    rng = np.random.default_rng(seed)
    return (rng.random((S, H, W, 3), np.float32) - 0.5,
            rng.standard_normal((10 * (S - 1) + 1, 6)).astype(np.float32),
            (t0 + np.cumsum(rng.uniform(0.08, 0.13, S))).astype(np.float32))


# ---------------------------------------------------------------------------
# the liquid cells and the pose cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elapsed", ["per_lane", "scalar"])
@pytest.mark.parametrize("kind", ["cfc", "ltc"])
def test_liquid_cell_matches_jax(kind, elapsed):
    """One cell update from a random hidden state, the elapsed time per
    lane (B,) or one scalar; the parameters bridged as the pose core's."""
    rng = np.random.default_rng(3)
    init = {"cfc": jliquid.init_cfc, "ltc": jliquid.init_ltc}[kind]
    p = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), 20, HIDDEN))
    if kind == "ltc":
        p["log_tau"] = (0.5 * rng.standard_normal(HIDDEN)).astype(np.float32)
    x = rng.standard_normal((B, 20)).astype(np.float32)
    h = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    dt = rng.uniform(0.05, 0.3, B).astype(np.float32) if elapsed == "per_lane" else 0.1
    ref = (jliquid.cfc_cell if kind == "cfc" else jliquid.ltc_cell)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(h), dt)
    if kind == "cfc":
        cell = liquid.CfCCell(20, HIDDEN)
        names = {"backbone.0": p["backbone"], **{n: p[n] for n in
                                                 ("ff1", "ff2", "time_a", "time_b")}}
    else:
        cell = liquid.LTCCell(20, HIDDEN)
        names = {"w_x": p["w_x"], "w_h": p["w_h"]}
    sd = {f"{n}.{k}": t(lin[j]) for n, lin in names.items()
          for k, j in (("weight", "w"), ("bias", "b"))}
    if kind == "ltc":
        sd.update(log_tau=t(p["log_tau"]), A=t(p["A"]))
    cell.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = cell(t(x), t(h), t(dt) if elapsed == "per_lane" else dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def jax_pose_core(jc):
    m = jc.model
    if m.model_type == "rnn":
        return JaxPoseRNN(m)
    return JaxPoseNCP(m, cell_type=m.model_type)


@pytest.mark.parametrize("core", sorted(CORES))
def test_pose_core_matches_jax(encoders, core):
    """The pose core alone on the same features: a cold window, then a
    carried one on a clock far from 0 (the rnn core ignores the times,
    the liquid cells read only their differences); poses and hidden state
    within rtol 1e-5, atol 1e-6, the carry's lane axis as declared."""
    jc, tc = configs(core)
    v = variables(encoders, jc)
    jcore, pv = jax_pose_core(jc), {"params": v["params"]["pose_net"]}
    pose = port_model(tc, v).Pose_net.eval()
    fv, fi, ts = features(0)
    fv2, fi2, ts2 = features(1, t0=1000.0)
    jp, jh = jcore.apply(pv, fv, fi, ts)
    jp2, jh2 = jcore.apply(pv, fv2, fi2, ts2, prev=jh)
    with torch.no_grad():
        p, h, stats = pose(t(fv), t(fi), t(ts))
        p2, h2, _ = pose(t(fv2), t(fi2), t(ts2), h)
    for got, ref in ((p, jp), (h, jh), (p2, jp2), (h2, jh2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert h.shape[pose.carry_lane_axis] == B
    assert int(stats.incomplete.sum()) == 0 and stats.incomplete.shape == (B,)
    if core in ("rnn", "gru"):
        # timestamps unused: a zero carry is no carry (JAX tests/test_models.py)
        with torch.no_grad():
            zero = pose(t(fv), t(fi), t(ts), torch.zeros_like(h))[0]
        assert torch.equal(zero, p)


@pytest.mark.parametrize("core", sorted(CORES))
def test_reference_layout_round_trip(encoders, core, tmp_path):
    """The port's state_dict keys are those JAX's export_deepvio writes (plus
    BatchNorm counters): its .npz loads strictly through ``--pretrain``'s
    loader into the bridged values, and JAX's convert_deepvio reads the
    port's state_dict back into the variables exactly."""
    jc, tc = configs(core)
    v = variables(encoders, jc)
    mt = tc.model.model_type
    hw = trunk_out_hw(H, W)
    exported = export_deepvio(v, mt, hw)
    model = create_model(tc, device="cpu")
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(exported) == keys
    np.savez(tmp_path / "ref.npz", **exported)
    load_pretrain(model, tmp_path / "ref.npz")
    bridged = from_jax_variables(v, tc.model)
    for k, x in model.state_dict().items():
        assert torch.equal(x, bridged[k]), k
    back = convert_deepvio({k: x.numpy() for k, x in model.state_dict().items()}, mt,
                           rnn_num_layers=tc.model.rnn_num_layers, conv_out_hw=hw)
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat(v)}
    got = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat(back)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the serving engine against JAX's
# ---------------------------------------------------------------------------

SCHEDULE = [
    (["a"], {"a": window(1, 0.0)}),
    (["b"], {"a": window(2, 0.3), "b": window(11, 5.0)}),
    ([], {"b": window(13, 5.6)}),  # a idles: its lane replays, carry restored
    ([], {"a": window(3, 0.6), "b": window(12, 5.3)}),
]


def serve(engine):
    sids, out = {}, {}
    for opens, served in SCHEDULE:
        for name in opens:
            sids[name] = engine.open_session()
        res = engine.step({sids[n]: w for n, w in served.items()})
        for n in served:
            out.setdefault(n, []).append(np.asarray(res[sids[n]]))
    return out


@pytest.mark.parametrize("core", ["rnn", "cfc"])
def test_engine_lanes_match_jax_engine(encoders, core):
    """Two sessions, one opened late and one idle for a window, through both
    engines (BatchNorm folded) on the bridged weights: the rnn core's
    (L, B, F) carry on lane axis 1 and the cfc core's (B, H) on axis 0,
    where the JAX engine's rule (axis 1 for leaves of 3 or more dims)
    agrees; poses within atol 1e-4."""
    jc, tc = configs(core)
    v = variables(encoders, jc)
    ref = JaxEngine(jax_create_model(jc), v, max_sessions=2)
    ref.warmup(window(0))
    want = serve(ref)
    eng = StreamingEngine(DeepVIO(tc.model), from_jax_variables(v, tc.model),
                          max_sessions=2, device="cpu")
    eng.warmup(window(0))
    got = serve(eng)
    assert eng._axis == (1 if core == "rnn" else 0)
    for name in want:
        assert len(got[name]) == len(want[name])
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# one train step of each family against JAX's make_train_step
# ---------------------------------------------------------------------------

def train_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, S, H, W, 3), np.float32) - 0.5,
            rng.standard_normal((B, 10 * (S - 1) + 1, 6)).astype(np.float32),
            (0.1 * rng.standard_normal((B, S - 1, 6))).astype(np.float32),
            np.cumsum(rng.uniform(0.08, 0.13, (B, S)), 1).astype(np.float32))


@pytest.mark.parametrize("core", ["rnn", "cfc", "ltc"])
def test_train_step_matches_jax(encoders, core):
    """One Adam step with the frozen image encoder's inference graph and
    ``rnn_dropout_out`` 0: metrics at rtol 1e-5, no truncated solve,
    params and statistics by ``compare_state``."""
    jc, tc = configs(core, freeze_encoder=True, frozen_encoder_eval=True)
    v = variables(encoders, jc)
    tx = jloop.make_optimizer(jc)
    jstate = jloop.create_train_state(jc, jax.tree_util.tree_map(jnp.asarray, v), tx,
                                      jax.random.PRNGKey(1))
    batch = train_batch(0)
    jstate, ref = jloop.make_train_step(jax_create_model(jc), tx, jc)(
        jstate, *map(jnp.asarray, batch))
    state = tloop.create_train_state(tc, port_model(tc, v), device="cpu")
    grads = recording(state)
    state, m = tloop.make_train_step(tc, device="cpu")(state, *batch)
    for k in ("loss", "angle_loss", "trans_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    assert int(m["solver_incomplete"]) == int(ref["solver_incomplete"]) == 0
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    compare_state(state.model, as_np(jstate.params), as_np(jstate.batch_stats), tc, grads)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("cores_cli")
    return base, make_kitti_tree(base / "kitti", seqs=("05",), n_frames=24, img_hw=(H, W),
                                 speed_scale=50.0)


@pytest.mark.parametrize("model_type", ["rnn", "cfc", "ltc"])
def test_cli_test_and_serve_run(tree, model_type):
    """``cli.test`` and ``cli.serve`` with ``--model_type`` rnn, cfc or ltc
    (random init) on a 24-frame sequence over 100 m: a summary with finite
    means, a served pose per frame."""
    base, root = tree
    common = ["--data_dir", str(root), "--save_dir", str(base / "results"), "--device", "cpu",
              "--img_w", str(W), "--img_h", str(H), "--seq_len", str(S), "--v_f_len", "32",
              "--i_f_len", "16", "--rnn_hidden_dim", str(HIDDEN), "--compute_dtype",
              "float32", "--model_type", model_type, "--val_seq", "05"]
    cli_test_main(["--experiment_name", model_type, *common])
    summary = (base / "results" / f"{model_type}_test" / "summary.txt").read_text()
    means = [float(x) for x in re.findall(r": (\S+) \+-", summary)]
    assert "seq 05" in summary and means and np.isfinite(means).all()
    report = serve_main(["--experiment_name", model_type, *common])
    assert report["frames"] == 23 and report["latency_ms_p50"] > 0
    served = np.loadtxt(base / "results" / f"{model_type}_serve" / "poses" / "05_pred.txt")
    assert served.shape[0] == 24 and np.isfinite(served).all()
