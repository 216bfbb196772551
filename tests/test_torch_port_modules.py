"""Each module of the port's serving slice against its JAX counterpart on
the same numpy inputs and the same (bridged) weights: encoders with and
without BatchNorm, fusion, the pose regressor, RNN cells, softplus and
PoseODERNN cold and carried. float32 compute: atol 1e-5 covers f32 sums
taken in another order through a few layers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.models.common import PoseRegressor as JaxPoseRegressor
from ode_vio_tpu.models.encoders import ImageEncoder as JaxImageEncoder
from ode_vio_tpu.models.encoders import InertialEncoder as JaxInertialEncoder
from ode_vio_tpu.models.fold import fold_batchnorm_into_bias as jax_fold
from ode_vio_tpu.models.fusion import FusionModule as JaxFusion
from ode_vio_tpu.models.pose_odernn import PoseODERNN as JaxPoseODERNN
from ode_vio_tpu.ops import rnn_cells as jax_cells
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.fold import fold_batchnorm_into_bias
from ode_vio_tpu_torch.ops import rnn_cells
from ode_vio_tpu_torch.ops.mlp import softplus

from torch_port_helpers import S, batch, configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
B = 2


def port_model(tc, variables, skip_bn=False):
    sd = from_jax_variables(variables, tc.model)
    cfg = tc.model
    if skip_bn:
        sd, cfg = fold_batchnorm_into_bias(sd), dataclasses.replace(cfg, skip_bn=True)
    model = DeepVIO(cfg, tc.solver).eval()
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def f32():
    jc, tc = configs()
    _, v = jax_model(jc)
    return jc, tc, v


def _encoders(jc, tc, v, skip_bn):
    jm = dataclasses.replace(jc.model, skip_bn=skip_bn)
    jv = jax_fold(v) if skip_bn else v
    img, imu, _ = batch([1, 2])
    ref_img = JaxImageEncoder(jm).apply(
        {"params": jv["params"]["image_encoder"],
         "batch_stats": jv["batch_stats"]["image_encoder"]}, jnp.asarray(img))
    ref_imu = JaxInertialEncoder(jm).apply(
        {"params": jv["params"]["inertial_encoder"],
         "batch_stats": jv["batch_stats"]["inertial_encoder"]}, jnp.asarray(imu))
    m = port_model(tc, v, skip_bn)
    with torch.no_grad():
        out_img = m.Image_net(torch.from_numpy(img))
        out_imu = m.Inertial_net(torch.from_numpy(imu))
    return (np.asarray(ref_img), out_img.numpy()), (np.asarray(ref_imu), out_imu.numpy())


@pytest.mark.parametrize("skip_bn", [False, True])
def test_encoders_f32(f32, skip_bn):
    (ri, oi), (ru, ou) = _encoders(*f32, skip_bn)
    assert oi.shape == (B, S - 1, 64) and ou.shape == (B, S - 1, 32)
    np.testing.assert_allclose(oi, ri, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(ou, ru, rtol=1e-5, atol=ATOL)


def test_encoders_bf16():
    """bf16 convs: the two frameworks round at other places (flax adds the
    conv bias after rounding the conv to bf16, PyTorch inside the conv),
    and bf16 keeps ~3 significant digits through nine layers: rtol 2e-2,
    atol 2e-2 of the output's scale."""
    jc, tc = configs(compute_dtype="bfloat16")
    _, v = jax_model(jc)
    for ref, out in _encoders(jc, tc, v, skip_bn=False):
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("method", ["cat", "soft"])
def test_fusion(method):
    jc, tc = configs(fuse_method=method)
    _, v = jax_model(jc)
    rng = np.random.default_rng(3)
    fv = rng.standard_normal((B, S - 1, 64)).astype(np.float32)
    fi = rng.standard_normal((B, S - 1, 32)).astype(np.float32)
    jp = {"params": v["params"]["pose_net"].get("fuse", {})}
    ref = JaxFusion(96, method).apply(jp, jnp.asarray(fv), jnp.asarray(fi))
    m = port_model(tc, v)
    with torch.no_grad():
        out = m.Pose_net.fuse(torch.from_numpy(fv), torch.from_numpy(fi))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=ATOL)


def test_hard_fusion_mask_statistics():
    """The Gumbel streams differ across frameworks: compare how often each
    feature is kept over 2000 draws with the analytic probability
    sigmoid(l0 - l1) (binomial std <= 0.011 per feature; bound 0.06)."""
    jc, tc = configs(fuse_method="hard")
    _, v = jax_model(jc)
    rng = np.random.default_rng(4)
    fv = rng.standard_normal((1, 1, 64)).astype(np.float32)
    fi = rng.standard_normal((1, 1, 32)).astype(np.float32)
    draws = 2000
    gate = v["params"]["pose_net"]["fuse"]
    feat = np.concatenate([fv, fi], -1)[0, 0]
    logits = (feat @ gate["gate"]["kernel"] + gate["gate"]["bias"]).reshape(96, 2)
    p_keep = 1.0 / (1.0 + np.exp(-(logits[:, 0] - logits[:, 1])))

    fuse = JaxFusion(96, "hard")
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    ref = jax.vmap(lambda k: fuse.apply({"params": gate}, jnp.asarray(fv),
                                        jnp.asarray(fi), rngs={"gumbel": k}))(keys)
    m = port_model(tc, v)
    with torch.no_grad():
        out = m.Pose_net.fuse(torch.from_numpy(fv).expand(draws, 1, 64),
                              torch.from_numpy(fi).expand(draws, 1, 32),
                              generator=torch.Generator().manual_seed(0))
    for keep in (np.asarray(ref)[:, 0, 0] != 0, out.numpy()[:, 0] != 0):
        np.testing.assert_allclose(keep.reshape(draws, 96).mean(0), p_keep, atol=0.06)


def test_pose_regressor(f32):
    _, tc, v = f32
    x = np.random.default_rng(5).standard_normal((B, S - 1, 96)).astype(np.float32)
    ref = JaxPoseRegressor().apply({"params": v["params"]["pose_net"]["regressor"]},
                                   jnp.asarray(x))
    with torch.no_grad():
        out = port_model(tc, v).Pose_net.regressor(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("cell", ["rnn", "gru"])
def test_rnn_cells(cell):
    rng = np.random.default_rng(6)
    g, hdim, L = rnn_cells.GATES[cell], 12, 2
    layers = [{k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in
               (("w_ih", (g * hdim, hdim)), ("w_hh", (g * hdim, hdim)),
                ("b_ih", (g * hdim,)), ("b_hh", (g * hdim,)))} for _ in range(L)]
    x = rng.standard_normal((3, hdim)).astype(np.float32)
    h = rng.standard_normal((L, 3, hdim)).astype(np.float32)
    ref_out, ref_h = jax_cells.step_stack(cell, layers, jnp.asarray(x), jnp.asarray(h))
    out, new_h = rnn_cells.step_stack(
        cell, [{k: torch.from_numpy(a) for k, a in p.items()} for p in layers],
        torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(new_h.numpy(), np.asarray(ref_h), rtol=1e-5, atol=ATOL)


def test_softplus_matches_jax_above_torch_threshold():
    """jax.nn.softplus is logaddexp(x, 0); torch's F.softplus returns x
    itself above threshold=20. The port's formula follows JAX."""
    x = np.linspace(-100, 100, 4001, dtype=np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("carried", [False, True])
def test_pose_odernn(f32, use_kernels, carried):
    """Cold start (clock re-based to 0) and carried hidden state (clock as
    given), through the solver core and through K1's wrapper (its plain
    version on CPU tensors); per-lane incomplete counts equal."""
    jc, tc, v = f32
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, use_kernels=use_kernels))
    rng = np.random.default_rng(7)
    fv = rng.standard_normal((B, S - 1, 64)).astype(np.float32)
    fi = rng.standard_normal((B, S - 1, 32)).astype(np.float32)
    _, _, ts = batch([8, 9], t0=0.7)
    prev = (0.5 * rng.standard_normal((2, B, 96))).astype(np.float32) if carried else None

    (ref_pose, ref_h), inter = JaxPoseODERNN(jc.model, jc.solver).apply(
        {"params": v["params"]["pose_net"]}, jnp.asarray(fv), jnp.asarray(fi),
        jnp.asarray(ts), prev=None if prev is None else jnp.asarray(prev),
        mutable=["intermediates"])
    ref_inc = np.asarray(inter["intermediates"]["ode_solves_incomplete"][0])

    m = port_model(tc, v)
    with torch.no_grad():
        pose, h, stats = m.Pose_net(
            torch.from_numpy(fv), torch.from_numpy(fi), torch.from_numpy(ts),
            prev=None if prev is None else torch.from_numpy(prev))
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref_pose), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(stats.incomplete.numpy(), ref_inc)
    assert int(stats.accepted) == int(inter["intermediates"]["ode_steps_accepted"][0])
