"""The port's CDE and RDE slice against the JAX package on the same numpy
inputs: control paths, kernel K2's plain version (fused_cde_solve on CPU
tensors) against the Pallas kernel in interpret mode and vmap(cdeint),
log-signatures, PoseCDE and PoseRDE over carried windows, the weight
bridge, and the StreamingEngine with the cde core.

Tolerances: single ops and paths are f32 through a few products (rtol
1e-6). Solves: the tolerance tests/test_pallas.py holds the Pallas kernel
to against XLA (rtol 3e-5, atol 3e-6). XLA on the CPU contracts a + b*c
into one FMA and PyTorch does not, so step counts are compared where the
case is not decided by rounding (see ROADMAP Queue 3). Pose cores: window
0 at rtol 2e-4 / atol 2e-5, later windows, which integrate from a carried
state where a flipped accept decision moves the solution at the solver's
own tolerance, at rtol 3e-2 / atol 5e-3 (tests/test_pallas.py:277)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.models.convert import export_deepvio, trunk_out_hw
from ode_vio_tpu.models.pose_cde import PoseCDE as JaxPoseCDE
from ode_vio_tpu.models.pose_rde import PoseRDE as JaxPoseRDE
from ode_vio_tpu.ops import interpolation as jinterp
from ode_vio_tpu.ops import logsig as jlogsig
from ode_vio_tpu.ops.mlp import apply_cde_func as jax_apply_cde_func
from ode_vio_tpu.ops.pallas_kernels import fused_cde_solve as jax_fused_cde_solve
from ode_vio_tpu.ops.solvers import SolverOptions as JaxSolverOptions
from ode_vio_tpu.serving import StreamingEngine as JaxEngine
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.ops import cuda_kernels, interpolation, logsig
from ode_vio_tpu_torch.ops.mlp import apply_cde_func
from ode_vio_tpu_torch.ops.solvers import SolverOptions
from ode_vio_tpu_torch.serving import StreamingEngine

from k2_step_log import assert_step_log_holds
from torch_port_helpers import S, configs, jax_model, one_torch_thread, window  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SOLVE_RTOL, SOLVE_ATOL = 3e-5, 3e-6
KW = dict(rtol=1e-3, atol=1e-6, dt0=1e-2, max_steps=64)
CDE_TINY = dict(cde_hidden_dim=8, cde_fn_num_layers=2, rde_reduced_dim=4)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# control paths
# ---------------------------------------------------------------------------

def path_inputs(seed, n=3, T=6, C=5, repeated=2):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.uniform(0.05, 0.3, (n, T)), 1).astype(np.float32)
    xs = rng.standard_normal((n, T, C)).astype(np.float32)
    ts[:, :repeated] = ts[:, repeated:repeated + 1]  # a collapsed prefix
    xs[:, :repeated] = xs[:, repeated:repeated + 1]
    return ts, xs


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_paths_evaluate_and_derivative(kind):
    """At, between and beyond the knots (a repeated knot, the end points,
    outside the span), every row on its own path."""
    ts, xs = path_inputs(1)
    rng = np.random.default_rng(2)
    lo, hi = ts[:, :1] - 0.1, ts[:, -1:] + 0.1
    query = np.concatenate([ts, lo + (hi - lo) * rng.random((3, 9))], 1).astype(np.float32)
    jpaths = jax.vmap(lambda a, b: jinterp.make_path(a, b, kind))(jnp.asarray(ts), jnp.asarray(xs))
    path = interpolation.make_path(t(ts), t(xs), kind)
    for k in range(query.shape[1]):
        q = query[:, k]
        for name in ("evaluate", "derivative"):
            ref = jax.vmap(lambda p, x: getattr(jinterp.InterpolatedPath(*p), name)(x))(
                tuple(jpaths), jnp.asarray(q))
            np.testing.assert_allclose(getattr(path, name)(t(q)).numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} at column {k}")
    for got, ref in zip(path, jpaths):  # the coefficients themselves
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # a repeated knot is a zero-length segment with slope 0
    assert np.all(path.b.numpy()[:, :2] == 0)


# ---------------------------------------------------------------------------
# K2: fused_cde_solve's plain version against the Pallas kernel and cdeint
# ---------------------------------------------------------------------------

def cde_problem(n=5, T=6, C=7, H=8, seed=0, repeated=False, eval_mid=False, amp=1.0):
    """tests/test_pallas.py::TestFusedCdeSolve's problem, from numpy, the
    path's values scaled by ``amp``."""
    rng = np.random.default_rng(seed)
    sizes = [H, H, H, H * C]
    params = [{"w": (rng.standard_normal((sizes[i + 1], sizes[i])) *
                     np.sqrt(2.0 / sizes[i])).astype(np.float32),
               "b": np.zeros(sizes[i + 1], np.float32)} for i in range(3)]
    z0 = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.05, 0.3, (n, T)), 1).astype(np.float32)
    xs = (amp * rng.standard_normal((n, T, C))).astype(np.float32)
    if repeated:
        ts[:, :2] = ts[:, 2:3]
        xs[:, :2] = xs[:, 2:3]
    ev = ts
    if eval_mid:
        ev = np.concatenate([0.5 * (ts[:, :-1] + ts[:, 1:]), ts[:, -1:]], 1)
    return params, z0, ts, xs, ev


def run_jax(params, z0, ts, xs, ev, kind, **kw):
    H, C = z0.shape[1], xs.shape[2]
    paths = jax.vmap(lambda a, b: jinterp.make_path(a, b, kind))(jnp.asarray(ts), jnp.asarray(xs))
    cubic = kind == "cubic"
    pallas = jax_fused_cde_solve(params, jnp.asarray(z0), paths.ts, paths.b,
                                 paths.c if cubic else None, paths.d if cubic else None,
                                 jnp.asarray(ev), activation="tanh", interpret=True, **kw)
    opts = JaxSolverOptions(method="dopri5", unroll_mode="while", **kw)

    def one(t_i, x_i, z_i, e_i):
        g = lambda z: jax_apply_cde_func(params, z, "tanh", H, C)  # noqa: E731
        return jinterp.cdeint(jinterp.make_path(t_i, x_i, kind), g, z_i, e_i, opts)

    zs, st = jax.vmap(one)(jnp.asarray(ts), jnp.asarray(xs), jnp.asarray(z0), jnp.asarray(ev))
    return ([np.asarray(a) for a in pallas],
            [np.asarray(a) for a in (zs, st.accepted, st.rejected, st.incomplete)])


def run_port(params, z0, ts, xs, ev, kind, **kw):
    layers = [(t(p["w"]), t(p["b"])) for p in params]
    path = interpolation.make_path(t(ts), t(xs), kind)
    cubic = kind == "cubic"
    before = cuda_kernels.fused_cde_solve.launches
    out = cuda_kernels.fused_cde_solve(layers, t(z0), path.ts, path.b,
                                       path.c if cubic else None, path.d if cubic else None,
                                       t(ev), activation="tanh", **kw)
    assert cuda_kernels.fused_cde_solve.launches == before  # CPU: the plain version
    return [a.numpy() for a in out]


def step_counts(params, z0, ts, xs, ev, kind, dtype=torch.float32, z_scale=1.0, **kw):
    """K2's plain version in ``dtype``: the per-row counts and zs."""
    layers = [(t(p["w"]).to(dtype), t(p["b"]).to(dtype)) for p in params]
    path = interpolation.make_path(t(ts).to(dtype), t(xs).to(dtype), kind)
    cubic = kind == "cubic"
    out = cuda_kernels.fused_cde_solve_plain(
        layers, t(z0).to(dtype) * z_scale, path.ts, path.b, path.c if cubic else None,
        path.d if cubic else None, t(ev).to(dtype), activation="tanh", method="dopri5",
        safety=0.9, factor_min=0.2, factor_max=10.0, **kw)
    return [a.numpy() for a in out[2:]]


def not_decided_by_rounding(problem, kind, **kw):
    """The step counts stay the same in float64 and with z0 moved by a few
    ulp. Where they do not, the controller's proposals after steps whose
    error ratio sits at the rounding's level (ramp-up from dt0, landings on
    a knot) decide the step sequence, and two correct f32 implementations
    part at the solver's tolerance instead of at rounding."""
    base = step_counts(*problem, kind, **kw)
    return all(np.array_equal(a, b) for other in (
        step_counts(*problem, kind, dtype=torch.float64, **kw),
        step_counts(*problem, kind, z_scale=1 + 2.0 ** -21, **kw)) for a, b in zip(base, other))


# (name, problem, kind, solver settings, counts compared). The path values
# are scaled by 0.1 and each seed is one whose counts are not decided by
# rounding (asserted); at test_pallas.py's scale (amp 1) most seeds are.
K2_CASES = [
    ("stepwise", dict(seed=0, amp=0.1), "linear", KW, True),
    ("cubic", dict(seed=1, amp=0.1), "cubic", KW, True),
    ("repeated_knots", dict(seed=0, amp=0.1, repeated=True), "linear", KW, True),
    ("eval_off_knots", dict(seed=2, T=5, amp=0.1, eval_mid=True), "linear", KW, True),
    ("budget", dict(seed=1, amp=0.1), "linear", dict(KW, dt0=5e-2, max_steps=4), True),
    # at rtol 1e-6 the error estimate sits at the rounding's scale: the
    # two implementations take different, equally valid steps
    ("ragged_tight", dict(n=3, C=13, H=16, seed=4),
     "linear", dict(rtol=1e-6, atol=1e-9, dt0=1e-2, max_steps=512), False),
]


@pytest.mark.parametrize("name,prob,kind,kw,counts", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_plain_matches_pallas_and_cdeint(name, prob, kind, kw, counts):
    problem = cde_problem(**prob)
    if counts:
        assert not_decided_by_rounding(problem, kind, **kw)
    (zs_pl, _, acc_pl, rej_pl, inc_pl), (zs_x, acc_x, rej_x, inc_x) = run_jax(*problem, kind, **kw)
    zs, dt, acc, rej, inc = run_port(*problem, kind, **kw)
    rtol, atol = (SOLVE_RTOL, SOLVE_ATOL) if counts else (2e-4, 2e-4)
    np.testing.assert_allclose(zs, zs_pl, rtol=rtol, atol=atol)
    np.testing.assert_allclose(zs, zs_x, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(inc, inc_pl)
    np.testing.assert_array_equal(inc, inc_x)
    if counts:
        for got, a, b in ((acc, acc_pl, acc_x), (rej, rej_pl, rej_x)):
            np.testing.assert_array_equal(got, a)
            np.testing.assert_array_equal(got, b)
        assert rej.sum() > 0  # the reject branch is reached
    if name == "repeated_knots":  # the collapsed segments take no step
        np.testing.assert_array_equal(zs[:, 0], problem[1])
        np.testing.assert_array_equal(zs[:, 1], problem[1])
    if name == "budget":
        assert inc.sum() > 0


def test_k2_wrapper_equals_solver_core_and_keeps_dt_over_empty_segments():
    """On CPU tensors cdeint_fused (K2's wrapper) and cdeint_batched (the
    solver core) give the same bits; a row whose segments all have zero
    length keeps z0 and the scalar dt0."""
    params, z0, ts, xs, ev = cde_problem(seed=6)
    ts[1] = ts[1, 0]  # row 1: every knot repeated
    xs[1] = xs[1, :1]
    ev = ts
    layers = [(t(p["w"]), t(p["b"])) for p in params]
    opts = SolverOptions(**KW)
    fused = interpolation.cdeint_fused(layers, "tanh", t(z0), t(ts), t(xs), t(ev), "linear", opts)
    g = lambda z: apply_cde_func(layers, z, "tanh", 8, 7)  # noqa: E731
    core = interpolation.cdeint_batched(g, t(z0), t(ts), t(xs), t(ev), "linear", opts)
    for a, b in zip((fused[0], *fused[1]), (core[0], *core[1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    path = interpolation.make_path(t(ts), t(xs), "linear")
    out = cuda_kernels.fused_cde_solve(layers, t(z0), path.ts, path.b, None, None, t(ev),
                                       **KW)
    np.testing.assert_array_equal(out[0][1].numpy(), np.broadcast_to(z0[1], (6, 8)))
    assert float(out[1][1]) == np.float32(KW["dt0"])
    assert int(out[2][1]) == int(out[3][1]) == int(out[4][1]) == 0


@pytest.mark.parametrize("name,prob,kind,kw,counts", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_step_log_accounts_for_every_attempt(name, prob, kind, kw, counts):
    """K2's plain version with its step log: the same bits as without, and
    a log that holds (``k2_step_log.py``)."""
    params, z0, ts, xs, ev = cde_problem(**prob)
    layers = [(t(p["w"]), t(p["b"])) for p in params]
    path = interpolation.make_path(t(ts), t(xs), kind)
    cubic = kind == "cubic"
    args = (layers, t(z0), path.ts, path.b, path.c if cubic else None,
            path.d if cubic else None, t(ev))
    out = cuda_kernels.fused_cde_solve(*args, activation="tanh", **kw)
    logged = cuda_kernels.fused_cde_solve(*args, activation="tanh", log_steps=True, **kw)
    assert logged[-1].shape == (z0.shape[0], ev.shape[1], kw["max_steps"], 2)
    assert_step_log_holds(out, logged, path.ts, t(ev))


# ---------------------------------------------------------------------------
# log-signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,window,depth", [(10, 20, 2), (10, 3, 2), (7, 4, 1)])
def test_logsig_windows(T, window, depth):
    rng = np.random.default_rng(T + window)
    xs = rng.standard_normal((2, T, 5)).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.08, 0.13, (2, T)), 1).astype(np.float32)
    ref = [jax.vmap(lambda x, s: jlogsig.logsig_windows(x, s, depth, window))(
        jnp.asarray(xs), jnp.asarray(ts))]
    ys, t_new = logsig.logsig_windows(t(xs), t(ts), depth=depth, window=window)
    assert ys.shape[-1] == logsig.logsig_dim(5, depth) == jlogsig.logsig_dim(5, depth)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref[0][0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(ref[0][1]))


# ---------------------------------------------------------------------------
# the pose cores over three carried windows
# ---------------------------------------------------------------------------

def core_configs(model_type, **kw):
    jc, tc = configs(model_type=model_type, **CDE_TINY, **kw)
    return jc, tc


@pytest.fixture(scope="module")
def cde_model():
    return jax_model(core_configs("cde")[0])


@pytest.fixture(scope="module")
def rde_model():
    return jax_model(core_configs("rde")[0])


def pose_windows(seed, n=3, scale=1.0):
    rng = np.random.default_rng(seed)
    out, t0 = [], np.zeros((2, 1))
    for _ in range(n):
        fv = (scale * rng.standard_normal((2, S - 1, 64))).astype(np.float32)
        fi = (scale * rng.standard_normal((2, S - 1, 32))).astype(np.float32)
        ts = (t0 + np.cumsum(rng.uniform(0.08, 0.13, (2, S)), 1)).astype(np.float32)
        t0 = ts[:, -1:].astype(np.float64)
        out.append((fv, fi, ts))
    return out


def leaves(carry):
    return [np.asarray(v) for _, v in sorted(carry.items())] if isinstance(carry, dict) \
        else [np.asarray(carry)]


# (model_type, streaming mode, cde_interpolation)
CORE_CASES = [("cde", "carry", "linear"), ("cde", "carry", "cubic"), ("cde", "reset", "linear"),
              ("cde", "history", "linear"), ("rde", "carry", "linear"),
              ("rde", "history", "linear")]


@pytest.fixture(scope="module")
def core_references(cde_model, rde_model):
    """The JAX pose core's windows for each CORE_CASES case, computed once
    for the case's two runs (solver core and K2's wrapper): a function of
    the case returning, per window, (poses, carry leaves, incomplete)."""
    cache = {}

    def reference(model_type, mode, interpolation):
        case = (model_type, mode, interpolation)
        if case not in cache:
            key = "cde_streaming_mode" if model_type == "cde" else "rde_streaming_mode"
            jc, _ = core_configs(model_type, cde_interpolation=interpolation, **{key: mode})
            v = (cde_model if model_type == "cde" else rde_model)[1]
            jcore = (JaxPoseCDE if model_type == "cde" else JaxPoseRDE)(jc.model,
                                                                         jc.cde_solver_cfg)
            jcarry, out = None, []
            for fv, fi, ts in pose_windows(12, scale=0.3):
                (ref_pose, jcarry), inter = jcore.apply(
                    {"params": v["params"]["pose_net"]}, jnp.asarray(fv), jnp.asarray(fi),
                    jnp.asarray(ts), prev=jcarry, mutable=["intermediates"])
                out.append((np.asarray(ref_pose), leaves(jcarry), np.asarray(
                    inter["intermediates"][f"{model_type}_solves_incomplete"][0])))
            cache[case] = out
        return cache[case]

    return reference


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("model_type,mode,interpolation", CORE_CASES)
def test_pose_core_over_carried_windows(model_type, mode, interpolation, use_kernels, cde_model,
                                        rde_model, core_references):
    """Through the solver core and through K2's wrapper (its plain version
    on CPU tensors); per-lane incomplete counts and the carry's leaves
    (history mode: z0, the ring buffer, the count) checked too. Features at
    0.3 of unit scale: at unit scale the tiny field's flow expands enough
    that for some seeds rounding alone moves window 0 by ~1e-3. The JAX
    core runs once for both (``core_references``)."""
    key = "cde_streaming_mode" if model_type == "cde" else "rde_streaming_mode"
    _, tc = core_configs(model_type, cde_interpolation=interpolation, **{key: mode})
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, use_kernels=use_kernels))
    v = (cde_model if model_type == "cde" else rde_model)[1]
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg).eval()
    model.load_state_dict(from_jax_variables(v, tc.model), strict=True)
    carry = None
    refs = core_references(model_type, mode, interpolation)
    for w, ((fv, fi, ts), (ref_pose, ref, ref_inc)) in enumerate(
            zip(pose_windows(12, scale=0.3), refs)):
        with torch.no_grad():
            pose, carry, stats = model.Pose_net(t(fv), t(fi), t(ts), prev=carry)
        rt, at = (2e-4, 2e-5) if w == 0 else (3e-2, 5e-3)
        np.testing.assert_allclose(pose.numpy(), ref_pose, rtol=rt, atol=at,
                                   err_msg=f"window {w}")
        got = leaves(carry)
        assert [a.shape for a in got] == [b.shape for b in ref]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=rt, atol=at, err_msg=f"carry, window {w}")
        np.testing.assert_array_equal(stats.incomplete.numpy(), ref_inc)


@pytest.mark.parametrize("model_type", ["cde", "rde"])
def test_bridge_keys_and_strict_load(model_type, cde_model, rde_model):
    v = (cde_model if model_type == "cde" else rde_model)[1]
    _, tc = core_configs(model_type)
    sd = from_jax_variables(v, tc.model)
    ref = export_deepvio(v, model_type, conv_out_hw=trunk_out_hw(tc.model.img_h, tc.model.img_w))
    ours = {k: x for k, x in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(ours) == sorted(ref)
    for k, x in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(x), err_msg=k)
    DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg).load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# the engine with the cde core
# ---------------------------------------------------------------------------

def serve(engine, schedule, watch=None):
    """schedule: per window, sessions to open, then {name: window}. Returns
    ({name: [poses]}, {name: session id}, carries of ``watch`` before and
    after each step)."""
    sids, out, seen = {}, {}, []
    for opens, served in schedule:
        for name in opens:
            sids[name] = engine.open_session()
        before = engine.hidden(sids[watch]) if watch in sids else None
        res = engine.step({sids[n]: w for n, w in served.items()})
        for n in served:
            out.setdefault(n, []).append(res[sids[n]])
        if before is not None:
            seen.append((watch in served, before, engine.hidden(sids[watch])))
    return out, sids, seen


SCHEDULE = [
    (["a"], {"a": window(1, 0.0)}),
    (["b"], {"a": window(2, 0.3), "b": window(11, 5.0)}),
    ([], {"a": window(3, 0.6), "b": window(12, 5.3)}),
    ([], {"b": window(13, 5.6)}),  # a idles: its lane replays, carry restored
]


# the late joiner of SCHEDULE served cold by JAX engines, which start a
# session cold only in their first step: alone, and beside a session that
# never submits (on SCHEDULE's lane 1)
B_ALONE = [(["b"], {"b": SCHEDULE[1][1]["b"]}), ([], {"b": SCHEDULE[2][1]["b"]}),
           ([], {"b": SCHEDULE[3][1]["b"]})]
LATE_COLD = [(["x"] + B_ALONE[0][0], B_ALONE[0][1])] + B_ALONE[1:]


def test_engine_cde_carry_matches_jax(cde_model):
    """Carry mode against the JAX engine: a cold start, carried windows, a
    late joiner and an idle replay. The port's late joiner starts cold,
    from ``tanh(initial(obs0))`` (the JAX engine starts it from z0 = 0), so
    its windows are held against a JAX engine that serves it alone from a
    cold start (``B_ALONE``). Each row's solve takes its own steps, so the
    lanes beside it move none of them: the same windows beside an idle lane
    (``LATE_COLD``) give the same poses to rounding (1.3e-5 of their scale at
    most; the port's carried windows are held to 3e-2)."""
    _, tc = core_configs("cde")
    jmodel, cde_variables = cde_model
    eng_j = JaxEngine(jmodel, cde_variables, max_sessions=2)
    ref, _, _ = serve(eng_j, SCHEDULE)
    eng_alone = JaxEngine(jmodel, cde_variables, max_sessions=1)
    ref["b"] = serve(eng_alone, B_ALONE)[0]["b"]
    eng_late = JaxEngine(jmodel, cde_variables, max_sessions=2)
    for got, want in zip(serve(eng_late, LATE_COLD)[0]["b"], ref["b"]):
        got, want = np.asarray(got), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg)
    eng = StreamingEngine(model, from_jax_variables(cde_variables, tc.model),
                          max_sessions=2, device="cpu")
    out, _, _ = serve(eng, SCHEDULE)
    for name in ref:
        for w, (got, want) in enumerate(zip(out[name], ref[name])):
            assert got.shape == (S - 1, 6) and np.isfinite(got).all()
            rt, at = (2e-4, 2e-5) if w == 0 else (3e-2, 5e-3)
            np.testing.assert_allclose(got, np.asarray(want), rtol=rt, atol=at)
    want_inc = [np.asarray(eng_j.incomplete_by_lane())[0],
                np.asarray(eng_alone.incomplete_by_lane())[0]]
    np.testing.assert_array_equal(eng.incomplete_by_lane(), want_inc)


def test_engine_history_lanes(cde_model):
    """History mode on the port's engine: the lane axis of every leaf is 0
    (z0 (B, H), buf (B, K, D), cnt (B,)); an idle session's carry is
    unchanged in every leaf; a session serves the same poses alone as
    beside another; a late joiner gets a zeroed lane in every leaf."""
    _, tc = core_configs("cde", cde_streaming_mode="history", cde_history_cap=6)
    sd = from_jax_variables(cde_model[1], tc.model)

    def engine():
        return StreamingEngine(DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg), sd,
                               max_sessions=2, device="cpu")

    eng = engine()
    out, sids, seen = serve(eng, SCHEDULE, watch="a")
    served_a, before, after = seen[-1]
    assert not served_a  # window 3: a idles
    for k in before:
        np.testing.assert_array_equal(after[k].numpy(), before[k].numpy(), err_msg=k)
    assert eng.hidden(sids["a"])["buf"].shape == (6, 9)
    assert int(eng.hidden(sids["a"])["cnt"]) == 6
    # a alone, same windows
    alone, _, _ = serve(engine(), [(["a"], {"a": SCHEDULE[0][1]["a"]}),
                                   ([], {"a": SCHEDULE[1][1]["a"]}),
                                   ([], {"a": SCHEDULE[2][1]["a"]})])
    for got, want in zip(out["a"], alone["a"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a late joiner: every leaf of its lane zeroed
    eng2 = engine()
    first = eng2.open_session()
    eng2.step({first: window(1)})
    late = eng2.open_session()
    for k, leaf in eng2.hidden(late).items():
        assert not leaf.any(), k
    assert int(eng2.hidden(first)["cnt"]) == S - 1
