"""Training the cde and rde pose cores in the port against the JAX package
at tiny widths (32x64 images, seq_len 4, features 32/16, CDE hidden 8 with
2 field layers, rde reduced to 4 channels, float32 compute, soft fusion):
the bounded, differentiable CDE solve (values, gradients and per-lane
counts), whole train steps, the parameter count, and that a training
forward never reaches kernel K2.

Tolerances. The bounded solve: values at the tolerance
tests/test_torch_port_cde.py holds the solves to (rtol 3e-5, atol 3e-6),
gradients within 5e-5 of each tensor's largest entry (XLA's FMA
contractions over the solve's stages; measured up to 8e-6); counts equal
on inputs screened as
that file screens them (ROADMAP Queue 3, "CDE step counts decided by
rounding"). Train steps: rde at rtol 1e-5 on the metrics. The cde field
of this size sees the un-normalised reduced features as its control path:
at rtol 1e-4 its step sequence is decided by rounding (solves that land on
a knot), which moves its solution by about the solver's own tolerance, so
the cde metrics are held at rtol 2e-3 with a step budget that truncates no
solve (max_steps_train 128), and the truncated-solve counts equal. rde
params after two Adam steps (where their gradient clears rounding) at
``compare_state``'s rtol 1e-4, atol 1e-6. Adam moves each param by about
lr * sign(g), so where rounding flips the sign of a small cde gradient the
frameworks part by 2 lr: the cde steps take SGD (momentum 0.9, lr 1e-2),
whose update is linear in the gradient, and each trained tensor's update
is held within 2e-3 of its largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu import config as jcfg
from ode_vio_tpu.models.deepvio import count_parameters as jax_count_parameters
from ode_vio_tpu.models.deepvio import create_model as jax_create_model
from ode_vio_tpu.models.deepvio import init_model
from ode_vio_tpu.ops import interpolation as jinterp
from ode_vio_tpu.ops.mlp import apply_cde_func as jax_apply_cde_func
from ode_vio_tpu.ops.solvers import SolverOptions as JaxSolverOptions
from ode_vio_tpu.training import loop as jloop
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.models import pose_cde
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO, count_parameters, create_model
from ode_vio_tpu_torch.ops import interpolation
from ode_vio_tpu_torch.ops.mlp import apply_cde_func
from ode_vio_tpu_torch.ops.solvers import SolverOptions
from ode_vio_tpu_torch.training import loop as tloop

from test_torch_port_cde import cde_problem, not_decided_by_rounding
from test_torch_port_train import compare_state, recording
from torch_port_helpers import one_torch_thread, randomize_batchnorm  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, S, H, W = 4, 4, 32, 64
TINY = dict(img_w=W, img_h=H, seq_len=S, v_f_len=32, i_f_len=16, cde_hidden_dim=8,
            cde_fn_num_layers=2, rde_reduced_dim=4, fuse_method="soft",
            compute_dtype="float32")
METRIC_RTOL = {"cde": 2e-3, "rde": 1e-5}
STEPS_TRAIN = {"cde": 128, "rde": 16}
# cde steps with SGD at lr 1e-2: Adam moves each param by about
# lr * sign(g), so where rounding flips the sign of a small gradient the
# two frameworks part by 2 lr; SGD's update is linear in the gradient
CDE_TRAIN = dict(optimizer="sgd", lr_warmup=1e-2)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# cdeint_batched in bounded mode against JAX's
# ---------------------------------------------------------------------------

KW = dict(rtol=1e-3, atol=1e-6, dt0=1e-2, max_steps=16)
# (name, problem, kind, solver settings); each problem's counts are not
# decided by rounding (asserted)
BOUNDED_CASES = [
    ("linear", dict(seed=0, amp=0.1), "linear", KW),
    ("cubic", dict(seed=1, amp=0.1), "cubic", KW),
    ("budget", dict(seed=1, amp=0.1), "linear", dict(KW, dt0=5e-2, max_steps=4)),
]


@pytest.mark.parametrize("name,prob,kind,kw", BOUNDED_CASES, ids=[c[0] for c in BOUNDED_CASES])
def test_bounded_cdeint_matches_jax(name, prob, kind, kw):
    """Values, per-lane counts, and the gradients of a fixed linear
    function of zs with respect to the field's weights, z0 and the path's
    observations, exit chunks of 4 steps."""
    params, z0, ts, xs, ev = cde_problem(**prob)
    assert not_decided_by_rounding((params, z0, ts, xs, ev), kind, **kw)
    Hd, C = z0.shape[1], xs.shape[2]
    proj = np.random.default_rng(9).standard_normal((*ev.shape, Hd)).astype(np.float32)
    jopts = JaxSolverOptions(method="dopri5", unroll_mode="bounded", exit_chunk=4, **kw)

    def jloss(p, z, x):
        g = lambda zz: jax_apply_cde_func(p, zz, "tanh", Hd, C)  # noqa: E731
        zs, st = jinterp.cdeint_batched(g, z, jnp.asarray(ts), x, jnp.asarray(ev), kind, jopts)
        return jnp.sum(zs * proj), (zs, st)

    (_, (jzs, jst)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(z0), jnp.asarray(xs))

    layers = [(t(p["w"]).requires_grad_(), t(p["b"]).requires_grad_()) for p in params]
    z0_t, xs_t = t(z0).requires_grad_(), t(xs).requires_grad_()
    g = lambda zz: apply_cde_func(layers, zz, "tanh", Hd, C)  # noqa: E731
    zs, st = interpolation.cdeint_batched(g, z0_t, t(ts), xs_t, t(ev), kind,
                                          SolverOptions(exit_chunk=4, **kw), bounded=True)
    grads = torch.autograd.grad(torch.sum(zs * t(proj)),
                                [w for layer in layers for w in layer] + [z0_t, xs_t])

    np.testing.assert_allclose(zs.detach().numpy(), np.asarray(jzs), rtol=3e-5, atol=3e-6)
    for got, ref in zip(st, jst):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert st.incomplete.shape == (z0.shape[0],)
    if name == "budget":
        assert int(st.incomplete.sum()) > 0
    jflat = [x for p in jgrads[0] for x in (p["w"], p["b"])] + list(jgrads[1:])
    for k, (got, ref) in enumerate(zip(grads, jflat)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=5e-5 * float(np.abs(ref).max()), err_msg=f"gradient {k}")


# ---------------------------------------------------------------------------
# whole train steps against JAX's make_train_step
# ---------------------------------------------------------------------------

def configs(model_type):
    """(JAX Config, port Config): the frozen image encoder's inference
    graph (no dropout anywhere), the CDE training budget of the core."""
    model = dict(TINY, model_type=model_type)
    train = dict(batch_size=B, freeze_encoder=True, frozen_encoder_eval=True,
                 **(CDE_TRAIN if model_type == "cde" else {}))
    cde = dict(rtol=1e-4, atol=1e-6, max_steps=256, max_steps_train=STEPS_TRAIN[model_type])
    return (jcfg.Config(model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(seq_len=S),
                        train=jcfg.TrainConfig(**train), cde_solver_cfg=jcfg.SolverConfig(**cde)),
            tcfg.Config(model=tcfg.ModelConfig(**model), train=tcfg.TrainConfig(**train),
                        cde_solver_cfg=tcfg.SolverConfig(**cde)))


def train_batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.random((B, S, H, W, 3), np.float32) - 0.5
    imu = rng.standard_normal((B, 10 * (S - 1) + 1, 6)).astype(np.float32)
    gts = (0.1 * rng.standard_normal((B, S - 1, 6))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.08, 0.13, (B, S)), 1).astype(np.float32)
    return img, imu, gts, ts


@pytest.fixture(scope="module", params=["cde", "rde"])
def reference(request):
    """JAX's make_train_step over the core's batches from seeded
    variables with random BatchNorm statistics."""
    mt = request.param
    jc, tc = configs(mt)
    _, v = init_model(jc, jax.random.PRNGKey(0))
    v = randomize_batchnorm(v)
    tx = jloop.make_optimizer(jc)
    state = jloop.create_train_state(jc, jax.tree_util.tree_map(jnp.asarray, v), tx,
                                     jax.random.PRNGKey(1))
    step = jloop.make_train_step(jax_create_model(jc), tx, jc)
    metrics = []
    for seed in (0, 1):
        state, m = step(state, *map(jnp.asarray, train_batch(seed)))
        metrics.append({k: float(x) for k, x in m.items()})
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return mt, tc, v, metrics, as_np(state.params), as_np(state.batch_stats)


def test_train_step_matches_jax(reference):
    """The port's make_train_step on the bridged weights and batches:
    loss, angle, trans and grad_norm within the core's rtol, truncated
    solves equal, params and statistics by ``compare_state``."""
    mt, tc, v, ref_metrics, ref_params, ref_stats = reference
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg)
    model.load_state_dict(from_jax_variables(v, tc.model), strict=True)
    state = tloop.create_train_state(tc, model, device="cpu")
    grads = recording(state)
    step = tloop.make_train_step(tc, device="cpu")
    for seed, ref in zip((0, 1), ref_metrics):
        state, m = step(state, *train_batch(seed))
        for k in ("loss", "angle_loss", "trans_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=METRIC_RTOL[mt], err_msg=k)
        assert int(m["solver_incomplete"]) == int(ref["solver_incomplete"])
    assert state.step == 2
    if mt == "rde":
        compare_state(state.model, ref_params, ref_stats, tc, grads)
        return
    # cde: each trained tensor's update within 2e-3 of its largest update,
    # but the tensors whose gradient is rounding noise (largest below 1e-5
    # of the step's, as compare_state: the conv biases before a BatchNorm);
    # every statistic within rtol 1e-4, atol 1e-6
    noise = {name for name in grads[0] if all(
        float(g[name].abs().max()) <= 1e-5 * max(float(x.abs().max()) for x in g.values())
        for g in grads)}
    before = from_jax_variables(v, tc.model)
    want = from_jax_variables({"params": ref_params, "batch_stats": ref_stats}, tc.model)
    for name, p in state.model.state_dict().items():
        got, ref, was = p.numpy(), want[name].numpy(), before[name].numpy()
        if name in grads[0] and name not in noise:
            step_ref = ref - was
            assert np.abs(step_ref).max() > 0, name
            np.testing.assert_allclose(got - was, step_ref, rtol=0,
                                       atol=2e-3 * float(np.abs(step_ref).max()), err_msg=name)
        elif name not in grads[0] and not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=name)
    assert len(noise) < 0.1 * len(grads[0])


def test_count_parameters_matches_jax(reference):
    """The port counts its parameters, not its BatchNorm buffers, as JAX
    counts its ``params`` tree."""
    mt, tc, v, *_ = reference
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg)
    assert count_parameters(model) == jax_count_parameters(v)
    assert sum(b.numel() for b in model.buffers()) > 0


@pytest.mark.parametrize("model_type", ["cde", "rde"])
def test_train_forward_never_reaches_k2(model_type, monkeypatch):
    """With use_kernels on, an eval forward solves through K2's wrapper; a
    train-mode forward never calls it, takes the bounded solve, and its
    poses carry gradients to the field."""
    _, tc = configs(model_type)
    cfg = tcfg.Config(model=tcfg.ModelConfig(**dict(TINY, model_type=model_type,
                                                     use_kernels=True)))
    model = create_model(cfg, seed=0, device="cpu")
    calls = []
    fused = pose_cde.cdeint_fused
    monkeypatch.setattr(pose_cde, "cdeint_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    bounded = []
    batched = interpolation.cdeint_batched
    monkeypatch.setattr(pose_cde, "cdeint_batched",
                        lambda *a, **k: bounded.append(a[-1]) or batched(*a, **k))
    img, imu, _, ts = (t(a) for a in train_batch(3))
    with torch.no_grad():
        model(img, imu, ts)
    assert calls == [1] and bounded == []
    model.train()
    poses, _, stats = model(img, imu, ts, generator=torch.Generator().manual_seed(0))
    assert calls == [1] and bounded == [True]
    assert stats.incomplete.shape == (B,)
    field = model.Pose_net.cde_func.net[0].weight
    assert float(torch.autograd.grad(poses.sum(), field)[0].abs().sum()) > 0
