"""The port's training slice against the JAX package at tiny widths
(32x64 images, seq_len 3, features 32/16, ODE hidden 16, 2 RNN layers,
float32 compute, softplus field, soft fusion): kernel K3's plain version
and autograd Function, the bounded differentiable solve, the encoders in
train mode, the optimiser and its schedule, and whole train steps. Same
numpy inputs on both sides; weights carried by ``from_jax_variables``.

The JAX K3 (``pallas_dropout``) has no interpret lowering on the CPU
(tests/test_pallas.py), and its bits come from the TPU's generator: K3 is
held to its semantics here and to its plain version on the card
(tests/test_torch_port_gpu.py, chip_smoke.py)."""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ode_vio_tpu import config as jcfg
from ode_vio_tpu.models.deepvio import create_model as jax_create_model
from ode_vio_tpu.models.deepvio import init_model
from ode_vio_tpu.models.encoders import ImageEncoder as JaxImageEncoder
from ode_vio_tpu.models.encoders import InertialEncoder as JaxInertialEncoder
from ode_vio_tpu.ops.mlp import apply_mlp as jax_apply_mlp
from ode_vio_tpu.ops.solvers import SolverOptions as JaxSolverOptions
from ode_vio_tpu.ops.solvers.odeint import solve_ivp_batched_dt as jax_solve_batched
from ode_vio_tpu.training import loop as jloop
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.models.common import train_dropout
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.encoders import TRUNK, TRUNK_NAMES, ImageEncoder, InertialEncoder
from ode_vio_tpu_torch.ops import cuda_kernels
from ode_vio_tpu_torch.ops.mlp import apply_mlp
from ode_vio_tpu_torch.ops.solvers import SolverOptions, odeint, solve_ivp_batched_dt
from ode_vio_tpu_torch.training import loop as tloop

from torch_port_helpers import one_torch_thread, randomize_batchnorm  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, S, H, W = 4, 3, 32, 64
TINY = dict(model_type="ode-rnn", img_w=W, img_h=H, seq_len=S, v_f_len=32, i_f_len=16,
            ode_hidden_dim=16, rnn_num_layers=2, ode_activation_fn="softplus",
            ode_fn_num_layers=2, fuse_method="soft", compute_dtype="float32")
TRUNK0 = tuple((f, k, s, 0.0) for f, k, s, _ in TRUNK)  # the trunk at dropout rate 0


def configs(model=None, **train):
    """(JAX Config, port Config) with the same model and train fields."""
    model = dict(TINY, **(model or {}))
    return (jcfg.Config(model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(seq_len=S),
                        train=jcfg.TrainConfig(batch_size=B, **train)),
            tcfg.Config(model=tcfg.ModelConfig(**model),
                        train=tcfg.TrainConfig(batch_size=B, **train)))


def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((B, S, H, W, 3), np.float32) - 0.5
    imu = rng.standard_normal((B, 10 * (S - 1) + 1, 6)).astype(np.float32)
    gts = (0.1 * rng.standard_normal((B, S - 1, 6))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.08, 0.13, (B, S)), 1).astype(np.float32)
    return img, imu, gts, ts


@pytest.fixture(scope="module")
def variables():
    """The tiny model's JAX variables, with random BatchNorm statistics."""
    jc, _ = configs()
    _, v = init_model(jc, jax.random.PRNGKey(0))
    return randomize_batchnorm(v)


def port_model(tc, v, image_trunk=TRUNK):
    model = DeepVIO(tc.model, tc.solver)
    if image_trunk is not TRUNK:
        model.Image_net = ImageEncoder(tc.model, image_trunk)
    model.load_state_dict(from_jax_variables(v, tc.model), strict=True)
    return model.train()


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# (a), (b): kernel K3's plain version and autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,words", [
    ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), 0xA4093822 | 0x299F31D0 << 32,
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, words):
    """Random123's known-answer vectors for Philox4x32-10 (key: low word
    first)."""
    out = cuda_kernels.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in out) == words


KEY = 0x0123456789ABCDEF


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_fraction(rate):
    """The keep fraction of 2^18 elements within 4 binomial sigmas of
    1 - rate."""
    n = 1 << 18
    y = cuda_kernels.fused_dropout_plain(torch.ones(n), KEY, rate)
    keep = float((y != 0).float().mean())
    assert abs(keep - (1 - rate)) < 4 * math.sqrt(rate * (1 - rate) / n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.2, 0.5, 0.999])
def test_dropout_kept_values_exact(dtype, rate):
    """Kept elements are x * 1/(1-rate) rounded once to x's type (the
    product taken exactly in float64 here), dropped ones 0."""
    x = (torch.randn(16387, generator=torch.Generator().manual_seed(1)) + 3).to(dtype)
    y = cuda_kernels.fused_dropout_plain(x, KEY, rate)
    keep = y != 0
    assert y.dtype == dtype and y.shape == x.shape and 0 < int(keep.sum()) < x.numel()
    want = (x.double() * (1.0 / (1.0 - rate))).to(dtype)
    assert torch.equal(y[keep], want[keep])


def test_dropout_rate_zero_returns_input():
    x = torch.randn(10)
    assert cuda_kernels.fused_dropout(x, KEY, 0.0) is x
    assert cuda_kernels.fused_dropout_plain(x, KEY, 0.0) is x
    assert train_dropout(x, 0.0, None, fast=True) is x
    with pytest.raises(ValueError, match="rate"):
        cuda_kernels.fused_dropout(x, KEY, 1.0)


def test_dropout_mask_follows_the_key():
    """The same key gives the same mask, another key another one; an
    element's bits depend on its index only (a prefix of odd length keeps
    its mask, as the kernel's tail does)."""
    x = torch.ones(1003)
    a = cuda_kernels.fused_dropout_plain(x, KEY, 0.5)
    assert torch.equal(a, cuda_kernels.fused_dropout_plain(x, KEY, 0.5))
    assert not torch.equal(a, cuda_kernels.fused_dropout_plain(x, KEY + 1, 0.5))
    assert not torch.equal(a, cuda_kernels.fused_dropout_plain(x, KEY ^ 1 << 40, 0.5))
    assert torch.equal(cuda_kernels.fused_dropout_plain(x[:601], KEY, 0.5), a[:601])
    assert torch.equal(cuda_kernels.fused_dropout_plain(x.reshape(17, 59), KEY, 0.5),
                       a.reshape(17, 59))


@pytest.mark.parametrize("kernel", [False, True])
def test_dropout_backward_regenerates_the_mask(kernel):
    """Backward drops the same elements as forward and scales the rest:
    dx = g * scale where kept. ``kernel`` True goes through K3's wrapper,
    i.e. the plain version on CPU tensors, with no launch counted."""
    x = (torch.rand(2, 3, 37, generator=torch.Generator().manual_seed(2)) + 0.5).requires_grad_()
    g = torch.randn(2, 3, 37, generator=torch.Generator().manual_seed(3))
    before = cuda_kernels.fused_dropout.launches
    y = cuda_kernels.FusedDropout.apply(x, KEY, 0.2, kernel)
    y.backward(g)
    keep = y.detach() != 0
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(x.grad, torch.where(keep, g * 1.25, torch.zeros(())))
    assert cuda_kernels.fused_dropout.launches == before


@pytest.mark.parametrize("grad_layout", ["channels_last", "contiguous"])
def test_dropout_counts_elements_in_memory_order(grad_layout):
    """A channels-last input (cuDNN's convolution output for the trunk's
    NHWC frames) keeps its layout and takes the mask of its memory order,
    with no copy; a gradient in another layout gets the forward's mask."""
    x = (torch.rand(2, 8, 5, 6, generator=torch.Generator().manual_seed(4)) + 0.5)
    x = x.to(memory_format=torch.channels_last).requires_grad_()
    y = cuda_kernels.FusedDropout.apply(x, KEY, 0.5, True)
    assert y.is_contiguous(memory_format=torch.channels_last)
    nhwc = cuda_kernels.fused_dropout_plain(x.detach().permute(0, 2, 3, 1).contiguous(), KEY, 0.5)
    assert torch.equal(y.detach(), nhwc.permute(0, 3, 1, 2))
    g = torch.randn(2, 8, 5, 6, generator=torch.Generator().manual_seed(5))
    if grad_layout == "channels_last":
        g = g.to(memory_format=torch.channels_last)
    y.backward(g)
    assert torch.equal(x.grad, torch.where(y.detach() != 0, g * 2.0, torch.zeros(())))


# ---------------------------------------------------------------------------
# (c): the bounded, differentiable solve against JAX's
# ---------------------------------------------------------------------------

def solve_problem(n=6, feat=8, hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [feat, hidden, hidden, feat]
    params = [{"w": (rng.standard_normal((sizes[i + 1], sizes[i])) *
                     np.sqrt(2.0 / sizes[i])).astype(np.float32),
               "b": (0.1 * rng.standard_normal(sizes[i + 1])).astype(np.float32)}
              for i in range(3)]
    y0 = (0.5 * rng.standard_normal((n, feat))).astype(np.float32)
    t0 = rng.uniform(0.0, 0.3, n).astype(np.float32)
    t1 = (t0 + rng.uniform(0.08, 0.13, n)).astype(np.float32)  # frame intervals
    t1[1] = t0[1]                                                # a zero-length row
    dt0 = rng.uniform(1e-3, 5e-2, n).astype(np.float32)          # warm starts
    dt0[0] = 1e-5                   # a cold start: its ramp-up takes a second chunk
    probe = rng.standard_normal((n, feat)).astype(np.float32)    # d(sum(probe*y1))
    return params, y0, t0, t1, dt0, probe


# (max_steps, exit_chunk): the training budget and chunk, a chunk that does
# not divide the budget, one chunk of the whole budget, a starved budget
SOLVE_CASES = [(16, 4), (16, 3), (16, 0), (3, 4)]


@pytest.mark.parametrize("max_steps,exit_chunk", SOLVE_CASES)
def test_bounded_solve_matches_jax(max_steps, exit_chunk):
    """y1 and the per-row counts of JAX's bounded solve_ivp_batched_dt,
    and the gradients of sum(probe * y1) with respect to y0 and the field's
    params (jax.grad against autograd). The controller's ratio and step
    size are constants on both sides: without their detach the port's
    gradients take a path through the step sizes that JAX cuts. f32 with
    sums in another order (XLA contracts a + b*c into FMAs): y1 rtol 2e-5,
    atol 2e-6 as the inference solve; gradients rtol 1e-4, atol 1e-5."""
    params, y0, t0, t1, dt0, probe = solve_problem()
    kw = dict(method="dopri5", rtol=1e-2, atol=1e-6, max_steps=max_steps,
              exit_chunk=exit_chunk)

    def jax_run(p, y):
        opts = JaxSolverOptions(unroll_mode="bounded", **kw)
        y1, _, st = jax_solve_batched(lambda t, yy: jax_apply_mlp(p, yy, "softplus"), y,
                                      jnp.asarray(t0), jnp.asarray(t1), opts, jnp.asarray(dt0))
        return jnp.sum(jnp.asarray(probe) * y1), (y1, st)

    (_, (ref_y, ref_st)), (ref_gp, ref_gy) = jax.value_and_grad(
        jax_run, argnums=(0, 1), has_aux=True)(params, jnp.asarray(y0))

    layers = [(torch.tensor(p["w"], requires_grad=True), torch.tensor(p["b"], requires_grad=True))
              for p in params]
    y = torch.tensor(y0, requires_grad=True)
    syncs = odeint.host_syncs
    y1, _, st = solve_ivp_batched_dt(lambda t, yy: apply_mlp(layers, yy, "softplus"), y,
                                     torch.from_numpy(t0), torch.from_numpy(t1),
                                     SolverOptions(**kw), torch.from_numpy(dt0))
    (torch.from_numpy(probe) * y1).sum().backward()

    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(ref_y), rtol=2e-5, atol=2e-6)
    for got, want in zip(st, ref_st):  # accepted, rejected, incomplete
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_steps == 3:
        assert st.incomplete.sum() > 0  # the starved budget truncates
    else:
        assert st.incomplete.sum() == 0 and st.accepted.max() > 4
    chunk = max_steps if exit_chunk <= 0 else min(exit_chunk, max_steps)
    assert odeint.host_syncs - syncs <= -(-max_steps // chunk)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(ref_gy), rtol=1e-4, atol=1e-5)
    for (w, b), g in zip(layers, ref_gp):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g["w"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g["b"]), rtol=1e-4, atol=1e-5)


def test_adjoint_mode_is_not_ported():
    """The adjoint mode, once refused, is now ported: ``from_config``
    keeps ``unroll_mode='adjoint'`` with the training budget, as JAX's
    does, and the plain solves refuse it as JAX's ``solve_ivp_dt`` does
    (the adjoint needs its parameters explicitly: ``solve_ivp_adjoint``)."""
    cfg = tcfg.SolverConfig(unroll_mode="adjoint")
    opts = SolverOptions.from_config(cfg, train=True)
    ref = JaxSolverOptions.from_config(jcfg.SolverConfig(unroll_mode="adjoint"), train=True)
    assert (opts.unroll_mode, opts.max_steps) == (ref.unroll_mode, ref.max_steps) == (
        "adjoint", cfg.max_steps_train)
    assert SolverOptions.from_config(cfg).max_steps == cfg.max_steps
    for solve in (odeint.solve_ivp_dt, solve_ivp_batched_dt):
        with pytest.raises(ValueError, match="solve_ivp_adjoint"):
            solve(lambda t, y: y, torch.zeros(2, 3), 0.0, 1.0, opts)


# ---------------------------------------------------------------------------
# (d): the encoders in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoders_train_mode_match_jax(variables, dtype):
    """Batch statistics, the running-statistics update (0.9 old + 0.1
    batch, biased variance) and the features, the trunk at dropout rate 0
    (JAX ``ImageEncoder(TRUNK=...)``). f32: rtol 1e-4, atol 1e-5 (a batch
    statistic is a sum over the batch taken in another order). bf16: the
    frameworks round at other places; rtol 2e-2 and atol 2e-2 of the
    output's scale, as the inference encoders (tests/
    test_torch_port_modules.py)."""
    jc, tc = configs({"compute_dtype": dtype})
    v = variables  # params are float32 whatever the compute type
    img, imu, _, _ = train_batch(1)
    ref_img, up_img = jax.jit(lambda p, s, x: JaxImageEncoder(jc.model, TRUNK=TRUNK0).apply(
        {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))(
        v["params"]["image_encoder"], v["batch_stats"]["image_encoder"], img)
    ref_imu, up_imu = jax.jit(lambda p, s, x: JaxInertialEncoder(jc.model).apply(
        {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))(
        v["params"]["inertial_encoder"], v["batch_stats"]["inertial_encoder"], imu)
    model = port_model(tc, v, TRUNK0)
    out_img = model.Image_net(torch.from_numpy(img))
    out_imu = model.Inertial_net(torch.from_numpy(imu))

    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2)
    for got, want in ((out_img, ref_img), (out_imu, ref_imu)):
        want = np.asarray(want)
        atol = tol.get("atol", 2e-2 * np.abs(want).max())
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol["rtol"], atol=atol)
    stats = [(getattr(model.Image_net, n)[1], up_img["batch_stats"][f"block{i}"]["bn"],
              v["batch_stats"]["image_encoder"][f"block{i}"]["bn"])
             for i, n in enumerate(TRUNK_NAMES)]
    stats += [(model.Inertial_net.encoder_conv[4 * j + 1], up_imu["batch_stats"][f"bn{j}"],
               v["batch_stats"]["inertial_encoder"][f"bn{j}"]) for j in range(3)]
    for bn, want, old in stats:
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            got = getattr(bn, ours).numpy()
            assert not np.array_equal(got, old[theirs])  # the batch moved them
            np.testing.assert_allclose(got, np.asarray(want[theirs]), rtol=tol["rtol"],
                                       atol=tol.get("atol", 2e-2 * np.abs(want[theirs]).max()))


def test_inertial_dropout_needs_a_generator():
    _, tc = configs({"imu_dropout": 0.5})
    enc = InertialEncoder(tc.model).train()
    imu = torch.from_numpy(train_batch()[1])
    with pytest.raises(ValueError, match="Generator"):
        enc(imu)
    a = enc(imu, torch.Generator().manual_seed(0))
    assert torch.equal(a, enc(imu, torch.Generator().manual_seed(0)))
    assert not torch.equal(a, enc(imu, torch.Generator().manual_seed(1)))


# ---------------------------------------------------------------------------
# (e): the optimiser, its groups and its schedule against optax
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adam_clip": dict(gradient_clip=0.5),
    "weight_decay": dict(weight_decay=1e-2),
    "sgd": dict(optimizer="sgd"),
    "freeze": dict(freeze_encoder=True),
    "regressor": dict(lr_regressor=5e-4, epochs_warmup=1, epochs_joint=1),
    "accumulate_2": dict(grad_accumulation_steps=2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(variables, case):
    """Three updates from the same gradients (random, with global norms
    above and below the clip): Optimizer, set_learning_rate with
    lr_for_epoch's rate for the step's epoch, as a trainer sets it, against
    the JAX package's optax chain. Params within rtol 1e-5, atol 1e-7
    (Adam's arithmetic in another order); frozen params bitwise."""
    jc, tc = configs(**OPT_CASES[case])
    params = as_numpy(variables["params"])
    tx = jloop.make_optimizer(jc)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    model = port_model(tc, variables)
    opt = tloop.Optimizer(model, tc)
    names = {id(p): n for n, p in model.named_parameters()}
    rng = np.random.default_rng(5)
    for step in range(3):
        scale = (1e-3, 1.0, 1e-2)[step]  # global norm about 0.4, 400, 4
        grads = jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), params)
        lr = jloop.lr_for_epoch(jc, step)
        assert lr == tloop.lr_for_epoch(tc, step)
        opt_state = jloop.set_learning_rate(opt_state, lr)
        tloop.set_learning_rate(opt, lr)
        params, opt_state = update(grads, opt_state, params)
        params = as_numpy(params)
        g_sd = from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]},
                                  tc.model)
        opt.step([g_sd[names[id(p)]] for p in opt.params])

    want = from_jax_variables({"params": params, "batch_stats": variables["batch_stats"]},
                              tc.model)
    before = from_jax_variables(variables, tc.model)
    for name, p in model.named_parameters():
        group = tloop.param_group(name, tc.train.freeze_encoder, tc.train.lr_regressor is not None)
        if group == "frozen":
            assert torch.equal(p.detach(), before[name])
        else:
            assert not torch.equal(p.detach(), before[name]), name
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
    groups = {g["name"]: g["lr"] for g in opt.inner.param_groups}
    assert groups["train"] == jloop.lr_for_epoch(jc, 2)
    if case == "regressor":
        assert groups["regressor"] == 5e-4
    with pytest.raises(KeyError):
        tloop.set_learning_rate(opt, 1e-3, group="nonexistent")


# ---------------------------------------------------------------------------
# (f): whole train steps against JAX's
# ---------------------------------------------------------------------------

def compare_state(model, jparams, jstats, tc, grads, rtol=1e-4):
    """The port's params and statistics against JAX's. Params where their
    gradient clears rounding: Adam's steps are about lr * sign(g), so where
    g is rounding noise the two frameworks step in opposite directions.
    Noise are the conv biases right before a BatchNorm, whose true gradient
    is 0 (about 1e-7 of the others), and, in a tensor, elements far below
    its largest (the two frameworks' conv1 gradients differ by 2e-5 of its
    largest). Compared, in tensors whose largest gradient is above 1e-5 of
    the step's largest: elements whose gradient is exactly 0 (taps that
    see only padding) or above 1e-3 of the tensor's largest, in every
    step. The noisy biases move the
    next batch's mean, so a running mean after them may differ by 0.1
    (1 - momentum) of theirs."""
    want = from_jax_variables({"params": jparams, "batch_stats": jstats}, tc.model)
    clear = {}
    for g_step in grads:
        top = max(float(g.abs().max()) for g in g_step.values())
        for name, g in g_step.items():
            big = float(g.abs().max())
            c = ((g == 0) | (g.abs() > 1e-3 * big)) & (big > 1e-5 * top)
            clear[name] = c if name not in clear else clear[name] & c
    state = model.state_dict()
    compared = total = 0
    for name, t in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = t.detach().numpy(), want[name].numpy()
        mask = clear[name].numpy() if name in clear else np.ones(got.shape, bool)
        atol = 1e-6
        if name.endswith("running_mean"):
            base, idx = name[:-len(".running_mean")].rsplit(".", 1)
            bias = f"{base}.{int(idx) - 1}.bias"
            if bias in state:
                atol += 0.1 * float((state[bias] - want[bias]).abs().max())
        np.testing.assert_allclose(got[mask], ref[mask], rtol=rtol, atol=atol, err_msg=name)
        compared += int(mask.sum())
        total += mask.size
    assert compared > 0.95 * total  # the mask must not hollow out the comparison


def recording(state):
    """Wrap the state's ``optimizer.step`` to keep each step's gradients
    by param name."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    seen, step = [], opt.step

    def record(grads):
        seen.append({names[id(p)]: g.detach().clone() for p, g in zip(opt.params, grads)})
        step(grads)

    opt.step = record
    return seen


def port_state(tc, v, image_trunk=TRUNK, seed=0):
    model = port_model(tc, v, image_trunk)
    return tloop.create_train_state(tc, model, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def frozen_eval_reference(variables):
    """JAX's own make_train_step, frozen_encoder_eval, over two steps."""
    jc, tc = configs(freeze_encoder=True, frozen_encoder_eval=True)
    model = jax_create_model(jc)
    tx = jloop.make_optimizer(jc)
    state = jloop.create_train_state(jc, jax.tree_util.tree_map(jnp.asarray, variables), tx,
                                     jax.random.PRNGKey(1))
    step = jloop.make_train_step(model, tx, jc)
    metrics = []
    for seed in (0, 1):
        state, m = step(state, *map(jnp.asarray, train_batch(seed)))
        metrics.append(as_numpy(m))
    return tc, metrics, as_numpy(state.params), as_numpy(state.batch_stats)


def test_train_step_frozen_encoder_eval_matches_jax(variables, frozen_eval_reference):
    """Two steps of make_train_step with freeze_encoder and
    frozen_encoder_eval (no dropout anywhere, the image encoder's folded
    inference graph): loss, angle, trans and grad_norm within rtol 1e-4,
    solver_incomplete equal, then params (where their gradient clears
    rounding) and all statistics within rtol 1e-4, atol 1e-6. The image
    encoder's weights and statistics stay bitwise where they were."""
    tc, ref_metrics, ref_params, ref_stats = frozen_eval_reference
    state = port_state(tc, variables)
    grads = recording(state)
    step = tloop.make_train_step(tc, device="cpu")
    before = {k: v.clone() for k, v in state.model.Image_net.state_dict().items()}
    for seed, ref in zip((0, 1), ref_metrics):
        state, m = step(state, *train_batch(seed))
        for k in ("loss", "angle_loss", "trans_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref[k]), rtol=1e-4, err_msg=k)
        assert int(m["solver_incomplete"]) == int(ref["solver_incomplete"])
    assert state.step == 2
    for k, v in state.model.Image_net.state_dict().items():
        assert torch.equal(v, before[k]), k
    compare_state(state.model, ref_params, ref_stats, tc, grads)


def jax_trunk_step(jc, v, batch, freeze):
    """One train step composed in JAX as make_train_step composes it, with
    the image encoder's trunk at dropout rate 0 (a field of the flax
    module that DeepVIO does not pass): the image encoder in train mode
    (batch statistics), then the inertial encoder and the pose core; the
    gradients of the frozen image encoder are zeros for the optimizer."""
    model = jax_create_model(jc)
    image_net = JaxImageEncoder(jc.model, TRUNK=TRUNK0)
    tx = jloop.make_optimizer(jc)
    img, imu, gts, ts = map(jnp.asarray, batch)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
    rngs = {"dropout": jax.random.PRNGKey(2), "gumbel": jax.random.PRNGKey(3)}

    def loss_fn(params):
        fv, up_img = image_net.apply(
            {"params": params["image_encoder"], "batch_stats": stats["image_encoder"]},
            img, train=True, mutable=["batch_stats"])
        if freeze:
            fv = jax.lax.stop_gradient(fv)
        (poses, _), up = model.apply({"params": params, "batch_stats": stats}, fv, imu, ts,
                                     train=True, rngs=rngs, method="pose_from_visual",
                                     mutable=["batch_stats", "intermediates"])
        angle = jnp.mean((poses[..., :3] - gts[..., :3]) ** 2)
        trans = jnp.mean((poses[..., 3:] - gts[..., 3:]) ** 2)
        new_stats = {**stats, **up["batch_stats"], "image_encoder": up_img["batch_stats"]}
        return jc.train.angle_loss_weight * angle + trans, new_stats

    @jax.jit
    def step(params):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        if freeze:
            grads = {**grads, "image_encoder": jax.tree_util.tree_map(
                jnp.zeros_like, grads["image_encoder"])}
        updates, _ = tx.update(grads, tx.init(params), params)
        return (loss, optax.global_norm(grads), optax.apply_updates(params, updates),
                new_stats, grads)

    loss, grad_norm, params, new_stats, grads = step(params)
    return float(loss), float(grad_norm), as_numpy(params), as_numpy(new_stats), as_numpy(grads)


@pytest.mark.parametrize("freeze", [True, False])
def test_train_step_trunk_in_train_mode_matches_jax(variables, freeze):
    """One step with the image encoder in train mode (batch statistics,
    running statistics updated), frozen (under no_grad) or trained, against
    the JAX composition at trunk dropout rate 0: loss and grad_norm within
    rtol 1e-4, params (where their gradient clears rounding) and every
    statistic within rtol 1e-4, atol 1e-6; frozen image weights bitwise
    unchanged. Weight decay is off here: with the clip active (the trained
    trunk's gradient norm is ~3000 against 5) a clipped gradient of 1e-3
    is ~2e-6, the size of the decay term 5e-5 * p, and their sum, which
    decides Adam's direction, is then rounding."""
    jc, tc = configs(freeze_encoder=freeze, weight_decay=0.0)
    batch = train_batch(2)
    loss, grad_norm, ref_params, ref_stats, _ = jax_trunk_step(jc, variables, batch, freeze)
    state = port_state(tc, variables, TRUNK0)
    grads = recording(state)
    before = {k: v.clone() for k, v in state.model.Image_net.named_parameters()}
    state, m = tloop.make_train_step(tc, device="cpu")(state, *batch)
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), grad_norm, rtol=1e-4)
    for k, p in state.model.Image_net.named_parameters():
        assert torch.equal(p.detach(), before[k]) == freeze, k
    compare_state(state.model, ref_params, ref_stats, tc, grads)


# ---------------------------------------------------------------------------
# (g): the port alone, K3's plain version on the trunk
# ---------------------------------------------------------------------------

def masked_loss(model, batch, seeds=range(4)):
    """The train-mode loss of ``model`` (a copy: train mode moves BatchNorm
    statistics) on ``batch``, averaged over the dropout masks of generator
    seeds ``seeds``: fixed masks, so it moves only with the params."""
    img, imu, gts, ts = (torch.from_numpy(a) for a in batch)
    total = 0.0
    for seed in seeds:
        with torch.no_grad():
            poses, _, _ = copy.deepcopy(model)(img, imu, ts,
                                                generator=torch.Generator().manual_seed(seed))
        total += float(100 * torch.mean((poses[..., :3] - gts[..., :3]) ** 2)
                       + torch.mean((poses[..., 3:] - gts[..., 3:]) ** 2))
    return total / len(seeds)


@pytest.fixture(scope="module")
def trained(variables):
    """Six steps of the flagship's train config (frozen image encoder in
    train mode, trunk dropout through K3's wrapper) on one batch."""
    _, tc = configs(freeze_encoder=True)
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, use_kernels=True))
    state = port_state(tc, variables, seed=7)
    image0 = {k: v.clone() for k, v in state.model.Image_net.state_dict().items()}
    step = tloop.make_train_step(tc, device="cpu")
    batch = train_batch(3)
    before = masked_loss(state.model, batch)
    losses = []
    for _ in range(6):
        state, m = step(state, *batch)
        losses.append(m["loss"])
    return tc, state, image0, losses, (before, masked_loss(state.model, batch))


def test_port_loss_falls(trained):
    """The step losses are finite; their masks differ from step to step
    (rate 0.5 on conv6's 1024 channels at 1x1 here), so the fall is read on
    the loss over four fixed masks, before and after the six steps."""
    _, _, _, losses, (before, after) = trained
    assert all(np.isfinite(float(x)) for x in losses)
    assert after < before


def test_port_frozen_weights_fixed_statistics_moving(trained):
    _, state, image0, _, _ = trained
    for k, v in state.model.Image_net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, image0[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, image0[k]), k


def test_port_same_seed_same_loss(variables, trained):
    """The generator's seed fixes every dropout mask: a fresh state from
    the same seed repeats the first step's loss bit for bit, another seed
    does not."""
    tc, _, _, losses, _ = trained
    step = tloop.make_train_step(tc, device="cpu")
    again = step(port_state(tc, variables, seed=7), *train_batch(3))[1]["loss"]
    other = step(port_state(tc, variables, seed=8), *train_batch(3))[1]["loss"]
    assert torch.equal(again, losses[0])
    assert not torch.equal(other, losses[0])


def test_train_step_refuses_other_pose_cores():
    """A pose core the JAX package lacks is a ValueError naming the six it
    has; every one of those six trains (tests/test_torch_port_train_cde.py,
    tests/test_torch_port_cores.py)."""
    _, tc = configs({"model_type": "lstm"})
    with pytest.raises(ValueError, match="not supported; choose from .*ltc"):
        tloop.make_train_step(tc, device="cpu")
