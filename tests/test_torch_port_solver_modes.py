"""The rest of the port's solver core against the JAX package's
(``ode_vio_tpu/ops/solvers/odeint.py``, ``ops/interpolation.py``): the
fixed-step and Adams solves, ``solve_at`` and ``cdeint``,
``initial_step_size``, the continuous adjoint ``solve_ivp_adjoint`` and
``cdeint_adjoint`` (also where its solves run out of their budget), and
the flags that select them. Same numpy inputs on both sides, every row
with its own interval; JAX's functions run per row under ``jax.vmap``.

Tolerances. The fixed-step and Adams solves take no decisions: values at
rtol 1e-5 / atol 1e-6, counts equal. The adaptive ``solve_at`` and
``cdeint`` at frame intervals: rtol 2e-5 / atol 2e-6, the inference
solve's (tests/test_torch_port_solver.py), counts equal. The adjoint:
y1 and every cotangent against ``jax.grad`` at rtol 1e-4 / atol 1e-6,
with solver tolerances (rtol 1e-6) far below that, so that a step
decision rounding flips (XLA contracts ``a + b*c`` into FMAs, PyTorch does
not) moves the result by less than the check's tolerance. The adjoint at
the flagship cde's training budget, where its solves truncate: in float64
on both sides, at rtol 1e-4 with an absolute floor of 1e-5 of each
tensor's largest entry."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu import config as jcfg
from ode_vio_tpu.cli.flags import build_parser as jax_build_parser
from ode_vio_tpu.cli.flags import config_from_args as jax_config_from_args
from ode_vio_tpu.ops import interpolation as jinterp
from ode_vio_tpu.ops.mlp import apply_cde_func as jax_apply_cde_func
from ode_vio_tpu.ops.mlp import apply_mlp as jax_apply_mlp
from ode_vio_tpu.ops.solvers import SolverOptions as JaxSolverOptions
from ode_vio_tpu.ops.solvers import odeint as jodeint
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.ops import interpolation
from ode_vio_tpu_torch.ops.mlp import apply_cde_func, apply_mlp
from ode_vio_tpu_torch.ops.solvers import (SolverOptions, odeint, solve_at, solve_ivp,
                                           solve_ivp_adjoint, solve_ivp_batched_dt,
                                           solve_ivp_dt)

from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FIXED_TOL = dict(rtol=1e-5, atol=1e-6)
ADAPTIVE_TOL = dict(rtol=2e-5, atol=2e-6)
ADJOINT_TOL = dict(rtol=1e-4, atol=1e-6)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_grad(fn, **kw):
    """``jax.value_and_grad`` compiled as one program."""
    return jax.jit(jax.value_and_grad(fn, **kw))


def mlp_params(sizes, rng, gain=1.0):
    return [{"w": (gain * rng.standard_normal((sizes[i + 1], sizes[i])) *
                   np.sqrt(2.0 / sizes[i])).astype(np.float32),
             "b": (0.1 * rng.standard_normal(sizes[i + 1])).astype(np.float32)}
            for i in range(len(sizes) - 1)]


def torch_layers(params, grad=False):
    return [(torch.tensor(p["w"], requires_grad=grad), torch.tensor(p["b"], requires_grad=grad))
            for p in params]


def ode_problem(n=5, feat=6, hidden=12, seed=0):
    """An MLP field with a time term (so the stage times count), rows with
    their own frame intervals, one of zero length."""
    rng = np.random.default_rng(seed)
    params = mlp_params([feat, hidden, hidden, feat], rng)
    y0 = (0.5 * rng.standard_normal((n, feat))).astype(np.float32)
    t0 = rng.uniform(0.0, 0.3, n).astype(np.float32)
    t1 = (t0 + rng.uniform(0.08, 0.13, n)).astype(np.float32)
    t1[1] = t0[1]
    probe = rng.standard_normal((n, feat)).astype(np.float32)
    return params, y0, t0, t1, probe


def jax_field(params):
    return lambda tt, y: jax_apply_mlp(params, y, "softplus") + 0.5 * tt


def port_field(layers):
    return lambda tt, y: apply_mlp(layers, y, "softplus") + 0.5 * tt[:, None]


# ---------------------------------------------------------------------------
# fixed-step and Adams solves
# ---------------------------------------------------------------------------

FIXED_CASES = [(m, 4) for m in ("euler", "rk4", "dopri5")] + [
    (m, n) for m in ("explicit_adams", "implicit_adams") for n in (1, 3, 6)]


@pytest.mark.parametrize("method,steps", FIXED_CASES)
def test_fixed_step_solve_matches_jax(method, steps):
    """y1, the returned step (t1 - t0) / n and the counts (n, 0, 0) of
    JAX's fixed-step solve (Adams: RK4 for the first min(3, n) steps),
    and the gradients of sum(probe * y1) through the training solve (which
    takes the same fixed steps) against jax.grad."""
    params, y0, t0, t1, probe = ode_problem()
    jopts = JaxSolverOptions(method=method, adaptive=False, fixed_steps=steps)

    def jax_run(p, y):
        y1, dt, st = jax.vmap(lambda yy, a, b: jodeint.solve_ivp_dt(
            jax_field(p), yy, a, b, jopts))(y, jnp.asarray(t0), jnp.asarray(t1))
        return jnp.sum(jnp.asarray(probe) * y1), (y1, dt, st)

    (_, (ref_y, ref_dt, ref_st)), (ref_gp, ref_gy) = jax_grad(
        jax_run, argnums=(0, 1), has_aux=True)(params, jnp.asarray(y0))

    opts = SolverOptions(method=method, adaptive=False, fixed_steps=steps)
    y1, dt, st = solve_ivp_dt(port_field(torch_layers(params)), t(y0), t(t0), t(t1), opts)
    np.testing.assert_allclose(y1.numpy(), np.asarray(ref_y), **FIXED_TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(ref_dt), **FIXED_TOL)
    for got, want in zip(st, ref_st):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.accepted.tolist() == [steps] * 5

    layers = torch_layers(params, grad=True)
    y = torch.tensor(y0, requires_grad=True)
    yb, _, _ = solve_ivp_batched_dt(port_field(layers), y, t(t0), t(t1), opts)
    assert torch.equal(yb.detach(), y1)
    (t(probe) * yb).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(ref_gy), **FIXED_TOL)
    for (w, b), g in zip(layers, ref_gp):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g["w"]), **FIXED_TOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g["b"]), **FIXED_TOL)


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_adams_strings_are_fixed_step(method):
    """``SolverOptions`` turns ``adaptive`` off for the Adams strings, so
    ``from_config`` gives what JAX's gives, and options built with
    ``adaptive=True`` take the fixed solve, as JAX's dispatch does."""
    cfg = dict(method=method, fixed_steps=5)
    opts = SolverOptions.from_config(tcfg.SolverConfig(**cfg), train=True)
    ref = JaxSolverOptions.from_config(jcfg.SolverConfig(**cfg), train=True)
    assert (opts.adaptive, opts.fixed_steps, opts.method) == (
        ref.adaptive, ref.fixed_steps, ref.method) == (False, 5, method)
    params, y0, t0, t1, _ = ode_problem(seed=1)
    field = port_field(torch_layers(params))
    adaptive = SolverOptions(method=method, fixed_steps=5, adaptive=True)
    assert adaptive.adaptive is False
    y1, st = solve_ivp(field, t(y0), t(t0), t(t1), adaptive)
    y2, _, st2 = solve_ivp_dt(field, t(y0), t(t0), t(t1), opts)
    assert torch.equal(y1, y2) and st.accepted.tolist() == [5] * 5
    assert st.rejected.sum() == 0 and st.incomplete.sum() == 0


# ---------------------------------------------------------------------------
# solve_at and cdeint
# ---------------------------------------------------------------------------

def knots(n, T, rng, t0=0.0):
    return (t0 + np.cumsum(rng.uniform(0.08, 0.13, (n, T)), 1)).astype(np.float32)


@pytest.mark.parametrize("adaptive", [True, False])
def test_solve_at_matches_jax(adaptive):
    """States at every row's knots after the first and the per-row counts
    summed over segments, the step size carried from one segment to the
    next (JAX's ``solve_at`` under ``jax.vmap``)."""
    params, y0, _, _, _ = ode_problem(seed=2)
    ts = knots(5, 5, np.random.default_rng(2))
    kw = dict(rtol=1e-3, atol=1e-6, max_steps=64, adaptive=adaptive, fixed_steps=3)
    jopts = JaxSolverOptions(unroll_mode="while", **kw)
    ref_y, ref_st = jax.jit(jax.vmap(lambda yy, k: jodeint.solve_at(jax_field(params), yy, k,
                                                                    jopts)))(
        jnp.asarray(y0), jnp.asarray(ts))
    ys, st = solve_at(port_field(torch_layers(params)), t(y0), t(ts), SolverOptions(**kw))
    assert ys.shape == (5, 4, 6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref_y), **(
        ADAPTIVE_TOL if adaptive else FIXED_TOL))
    for got, want in zip(st, ref_st):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if adaptive:  # a step at least per segment
        assert int(st.accepted.min()) >= 4
    else:
        assert st.accepted.tolist() == [12] * 5


def cde_problem(B=4, T=5, H=4, C=3, seed=3, gain=0.5, grid=True):
    """A CDE field and paths at frame intervals. With ``grid`` the knots
    lie on a grid of 1/64 s (steps of 5-8/64): a fixed step of a
    power-of-two fraction of a segment then puts its stage times exactly on
    the knots in both frameworks. Off that grid, the stage at a segment's
    end lands on one side of the knot or the other by rounding of
    ``t0 + k * dt`` (XLA contracts it into an FMA, PyTorch does not), and
    on a linear path the two sides' slopes differ (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(seed)
    params = mlp_params([H, H, H * C], rng, gain)
    ts = (np.cumsum(rng.integers(5, 9, (B, T)), 1) / 64).astype(np.float32) if grid else \
        knots(B, T, rng)
    xs = rng.standard_normal((B, T, C)).astype(np.float32)
    z0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    return params, ts, xs, z0


@pytest.mark.parametrize("kind,method,adaptive", [
    ("linear", "dopri5", True), ("cubic", "dopri5", True), ("linear", "rk4", False),
    ("cubic", "implicit_adams", False)])
def test_cdeint_matches_jax(kind, method, adaptive):
    """``cdeint`` (one ``solve_at`` through ``[ts[0]] + ts_eval``) on a
    linear or cubic path: states and per-row counts of JAX's ``cdeint``
    under ``jax.vmap``, adaptive at rtol 1e-2 on knots whose landings
    rounding does not decide, fixed-step and Adams on the 1/64 s grid."""
    params, ts, xs, z0 = cde_problem(grid=not adaptive)
    H, C = z0.shape[1], xs.shape[2]
    kw = dict(method=method, rtol=1e-2, atol=1e-6, max_steps=64, dt0=1e-2,
              adaptive=adaptive, fixed_steps=4)
    jopts = JaxSolverOptions(unroll_mode="while", **kw)

    def one(k, x, z):
        return jinterp.cdeint(jinterp.make_path(k, x, kind),
                              lambda zz: jax_apply_cde_func(params, zz, "tanh", H, C),
                              z, k[1:], jopts)

    ref_z, ref_st = jax.jit(jax.vmap(one))(jnp.asarray(ts), jnp.asarray(xs), jnp.asarray(z0))
    layers = torch_layers(params)
    zs, st = interpolation.cdeint(interpolation.make_path(t(ts), t(xs), kind),
                                  lambda z: apply_cde_func(layers, z, "tanh", H, C),
                                  t(z0), t(ts)[:, 1:], SolverOptions(**kw))
    np.testing.assert_allclose(zs.numpy(), np.asarray(ref_z), **(
        ADAPTIVE_TOL if adaptive else FIXED_TOL))
    for got, want in zip(st, ref_st):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # cdeint_path (K2's plain version) carries what the fixed solve returns
    zp, dt, _ = interpolation.cdeint_path(lambda z: apply_cde_func(layers, z, "tanh", H, C),
                                          t(z0), interpolation.make_path(t(ts), t(xs), kind),
                                          t(ts)[:, 1:], SolverOptions(**kw))
    assert torch.equal(zp, zs)
    if not adaptive:
        np.testing.assert_allclose(dt.numpy(), (ts[:, -1] - ts[:, -2]) / 4, **FIXED_TOL)


def test_initial_step_size_matches_jax():
    """Per row, as ``jax.vmap`` of JAX's ``initial_step_size``; a row at
    rest (y0 = 0 and a zero field) takes the heuristic's 1e-6 branch."""
    params, y0, t0, _, _ = ode_problem(seed=4)
    params[-1]["w"][:] = 0.0
    params[-1]["b"][:] = 0.0
    y0[2] = 0.0
    field = lambda tt, y: jax_apply_mlp(params, y, "softplus") + y  # noqa: E731
    ref = jax.jit(jax.vmap(lambda y, a: jodeint.initial_step_size(field, y, a, 5, 1e-3, 1e-6)))(
        jnp.asarray(y0), jnp.asarray(t0))
    layers = torch_layers(params)
    got = odeint.initial_step_size(lambda tt, y: apply_mlp(layers, y, "softplus") + y,
                                   t(y0), t(t0), 5, 1e-3, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    assert float(got[2]) == pytest.approx(1e-6)
    assert len(set(got.tolist())) == 5


# ---------------------------------------------------------------------------
# the continuous adjoint
# ---------------------------------------------------------------------------

ADJ_KW = dict(rtol=1e-6, atol=1e-8, dt0=1e-2, max_steps=256)


@pytest.mark.parametrize("method", ["dopri5", "rk4"])
def test_solve_ivp_adjoint_matches_jax(method):
    """y1 and the cotangents of sum(probe * y1) for y0, the shared weights,
    a per-row argument (each row's own input, a lane argument), t0 and t1
    against ``jax.grad`` through ``jax.vmap`` of JAX's ``solve_ivp_adjoint``
    (its ``custom_vjp``), every row on its own interval. dopri5 adaptive;
    rk4 fixed-step (the adjoint then takes fixed steps both ways)."""
    params, y0, t0, t1, probe = ode_problem(seed=5)
    u = np.random.default_rng(5).standard_normal((5, 6)).astype(np.float32)
    kw = dict(ADJ_KW, method=method, adaptive=method == "dopri5", fixed_steps=8)

    def jfunc(tt, y, args):
        p, lane = args
        return jax_apply_mlp(p, y, "tanh") + lane * tt

    def jax_loss(p, y, lane, a, b):
        y1 = jax.vmap(lambda yy, ll, aa, bb: jodeint.solve_ivp_adjoint(
            jfunc, JaxSolverOptions(**kw), yy, aa, bb, (p, ll)))(y, lane, a, b)
        return jnp.sum(jnp.asarray(probe) * y1), y1

    (_, ref_y), ref_g = jax_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        params, *map(jnp.asarray, (y0, u, t0, t1)))

    layers = torch_layers(params, grad=True)
    flat = tuple(x for layer in layers for x in layer)
    y, lane, a, b = (torch.tensor(x, requires_grad=True) for x in (y0, u, t0, t1))

    def func(tt, yy, args, lane_args):
        return apply_mlp(list(zip(args[::2], args[1::2])), yy, "tanh") + lane_args[0] * tt[:, None]

    y1 = solve_ivp_adjoint(func, SolverOptions(**kw), y, a, b, flat, (lane,))
    (t(probe) * y1).sum().backward()
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(ref_y), **ADJOINT_TOL)
    gp, gy, glane, ga, gb = ref_g
    for got, want in ((y.grad, gy), (lane.grad, glane), (a.grad, ga), (b.grad, gb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ADJOINT_TOL)
    for (w, bias), g in zip(layers, gp):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g["w"]), **ADJOINT_TOL)
        np.testing.assert_allclose(bias.grad.numpy(), np.asarray(g["b"]), **ADJOINT_TOL)
    assert np.abs(np.asarray(ga)).max() > 0


def test_adjoint_args_bar_is_per_row():
    """Each row's backward solve carries its own parameter cotangent in
    its error norm, as ``jax.vmap`` makes it: the shared cotangent of rows
    solved together equals the sum of the rows' cotangents solved one row
    at a time (within float32 sums over batches of other sizes; a norm
    shared by the rows would move it by the solver's rtol 1e-3)."""
    params, y0, t0, t1, probe = ode_problem(seed=6)
    t1 = t0 + 0.6
    layers = torch_layers(params, grad=True)
    flat = tuple(x for layer in layers for x in layer)
    opts = SolverOptions(rtol=1e-3, atol=1e-6, dt0=1e-2, max_steps=64)

    def func(tt, yy, args, lane_args):
        return apply_mlp(list(zip(args[::2], args[1::2])), yy, "tanh")

    def grads(rows):
        y1 = solve_ivp_adjoint(func, opts, t(y0[rows]), t(t0[rows]), t(t1[rows]), flat)
        return torch.autograd.grad((t(probe[rows]) * y1).sum(), flat)

    together = grads(list(range(5)))
    alone = [grads([i]) for i in range(5)]
    for k, g in enumerate(together):
        np.testing.assert_allclose(g.numpy(), sum(a[k] for a in alone).numpy(),
                                   **ADJOINT_TOL)


@pytest.mark.parametrize("kind,method", [("linear", "implicit_adams"), ("cubic", "dopri5")])
def test_cdeint_adjoint_matches_jax(kind, method):
    """``cdeint_adjoint``: zs and the gradients of sum(probe * zs) for the
    field's weights, z0 and the observations ``xs`` (through all five path
    leaves) against ``jax.grad`` through ``jax.vmap`` of JAX's. Fixed Adams
    steps (8 a segment, the first 3 RK4) on a linear path; the adaptive case takes a
    cubic path, whose slope is continuous at the knots: on a linear path
    the adaptive solves' landings on a knot are decided by rounding (their
    rejections, ROADMAP.md Queue 3), which at rtol 1e-6 moved one weight's
    cotangent by 3e-6 of its largest entry against JAX's."""
    params, ts, xs, z0 = cde_problem(T=4, seed=7)
    H, C = z0.shape[1], xs.shape[2]
    probe = np.random.default_rng(7).standard_normal((4, 3, H)).astype(np.float32)
    kw = (ADJ_KW if method == "dopri5" else
          dict(ADJ_KW, method=method, adaptive=False, fixed_steps=8))
    jopts = JaxSolverOptions(**kw)

    def jax_loss(p, x, z):
        def one(k, xx, zz):
            return jinterp.cdeint_adjoint(
                jinterp.make_path(k, xx, kind), zz, k[1:], p,
                lambda pp, q: jax_apply_cde_func(pp, q, "tanh", H, C), jopts)

        zs = jax.vmap(one)(jnp.asarray(ts), x, z)
        return jnp.sum(jnp.asarray(probe) * zs), zs

    (_, ref_z), (gp, gx, gz) = jax_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(xs), jnp.asarray(z0))

    layers = torch_layers(params, grad=True)
    flat = [x for layer in layers for x in layer]
    x, z = torch.tensor(xs, requires_grad=True), torch.tensor(z0, requires_grad=True)
    zs = interpolation.cdeint_adjoint(
        interpolation.make_path(t(ts), x, kind), z, t(ts)[:, 1:], flat,
        lambda ps, q: apply_cde_func(list(zip(ps[::2], ps[1::2])), q, "tanh", H, C),
        SolverOptions(**kw))
    (t(probe) * zs).sum().backward()
    np.testing.assert_allclose(zs.detach().numpy(), np.asarray(ref_z), **ADJOINT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **ADJOINT_TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(gz), **ADJOINT_TOL)
    for (w, b), g in zip(layers, gp):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g["w"]), **ADJOINT_TOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g["b"]), **ADJOINT_TOL)
    assert np.abs(np.asarray(gx)).max() > 0


TRUNCATED_KW = dict(method="dopri5", rtol=1e-4, atol=1e-6, dt0=1e-4, max_steps=16)


@functools.cache
def truncated_jax_grad():
    """JAX's gradients of sum(probe * zs) through ``cdeint_adjoint`` at
    ``TRUNCATED_KW`` for the weights, xs and z0, compiled once for every
    seed (field 6 -> 6 -> 18, linear paths)."""
    jopts = JaxSolverOptions(**TRUNCATED_KW)

    def loss(p, x, z, ts, probe):
        def one(k, xx, zz):
            return jinterp.cdeint_adjoint(
                jinterp.make_path(k, xx, "linear"), zz, k[1:], p,
                lambda pp, q: jax_apply_cde_func(pp, q, "tanh", 6, 3), jopts)

        zs = jax.vmap(one)(ts, x, z)
        return jnp.sum(probe * zs), zs

    return jax_grad(loss, argnums=(0, 1, 2), has_aux=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cdeint_adjoint_truncated_matches_jax(seed):
    """``cdeint_adjoint`` at the flagship cde's training options (dopri5,
    rtol 1e-4, atol 1e-6, dt0 1e-4, the training budget of 16 steps) on a
    linear path, where at least half the backward solves run out of their
    budget before their segment's start: zs and the gradients for the
    field's weights, z0 and xs against JAX's. There every step decision,
    and so the norm of each row's flattened augmented state, decides where
    a solve stops. In float64 on both sides: in float32 the first steps'
    error ratios from dt0 1e-4 are rounding noise, so rounding decides
    their growth factors, and a truncated solve stops elsewhere in each
    package (ROADMAP.md Queue 3)."""
    params, ts, xs, z0 = cde_problem(B=4, T=4, H=6, C=3, seed=seed, gain=1.0, grid=False)
    params = [{k: v.astype(np.float64) for k, v in p.items()} for p in params]
    ts, xs, z0 = ts.astype(np.float64), 3.0 * xs.astype(np.float64), z0.astype(np.float64)
    probe = np.random.default_rng(seed).standard_normal((4, 3, 6))
    H, C = 6, 3
    with jax.enable_x64(True):
        (_, ref_z), (gp, gx, gz) = truncated_jax_grad()(
            params, *map(jnp.asarray, (xs, z0, ts, probe)))
        ref_z, gx, gz = np.asarray(ref_z), np.asarray(gx), np.asarray(gz)
        gp = [{k: np.asarray(v) for k, v in g.items()} for g in gp]

    layers = torch_layers(params, grad=True)
    flat = [x for layer in layers for x in layer]
    x, z = torch.tensor(xs, requires_grad=True), torch.tensor(z0, requires_grad=True)
    truncated = odeint.adjoint_incomplete
    zs = interpolation.cdeint_adjoint(
        interpolation.make_path(t(ts), x, "linear"), z, t(ts)[:, 1:], flat,
        lambda ps, q: apply_cde_func(list(zip(ps[::2], ps[1::2])), q, "tanh", H, C),
        SolverOptions(**TRUNCATED_KW))
    (t(probe) * zs).sum().backward()
    assert zs.dtype == torch.float64
    assert odeint.adjoint_incomplete - truncated >= 6  # of 4 rows x 3 segments

    def close(got, want, name):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)

    close(zs, ref_z, "zs")
    close(x.grad, gx, "xs")
    close(z.grad, gz, "z0")
    for i, ((w, b), g) in enumerate(zip(layers, gp)):
        close(w.grad, g["w"], f"w{i}")
        close(b.grad, g["b"], f"b{i}")


# ---------------------------------------------------------------------------
# the flags that select the modes
# ---------------------------------------------------------------------------

TINY_FLAGS = ["--img_h", "32", "--img_w", "64", "--seq_len", "3", "--v_f_len", "16",
              "--i_f_len", "8", "--ode_hidden_dim", "12"]
MODE_FLAGS = {"adjoint": ["--adjoint"], "ode_fixed_step": ["--ode_fixed_step"],
              **{f"{flag}_{m}": [f"--{flag}", m] for flag in ("ode_solver", "cde_solver")
                 for m in ("explicit_adams", "implicit_adams")}}


@pytest.mark.parametrize("name", sorted(MODE_FLAGS))
def test_mode_flags_build_jax_config(name):
    """``--adjoint``, ``--ode_fixed_step`` and the Adams method strings,
    once refused, now build the fields JAX's ``config_from_args`` builds,
    away from their defaults, and the solver options JAX derives from them
    for training and for evaluation: each field the port's options have,
    the inference mode being ``'while'``, which JAX's models set. (JAX's
    ``remat_chunks`` is not ported: the port's bounded solve never runs
    the chunks after every row is done, so it records none.)"""
    argv = [*TINY_FLAGS, *MODE_FLAGS[name]]
    ref = jax_config_from_args(jax_build_parser().parse_args(argv))
    got = config_from_args(build_parser().parse_args(argv))
    default = config_from_args(build_parser().parse_args(TINY_FLAGS))

    def fields(c):
        return (c.model.adjoint, c.solver.adaptive, c.solver.unroll_mode, c.solver.method,
                c.cde_solver_cfg.method, c.cde_solver_cfg.adaptive, c.solver.fixed_steps)

    assert fields(got) == fields(ref) != fields(default)
    for which in ("solver", "cde_solver_cfg"):
        for train in (True, False):
            mine = dataclasses.asdict(SolverOptions.from_config(getattr(got, which), train))
            theirs = dataclasses.asdict(JaxSolverOptions.from_config(getattr(ref, which), train))
            if not train:  # the mode JAX's models give their inference solves
                theirs["unroll_mode"] = "while"
            assert mine == {k: theirs[k] for k in mine}, (which, train)
