"""The port's cde core (``DeepVIO``, carry mode) against the benchmark's
plain reference (``vio_bench/reference/model.py``) on seeded random
weights (``vio_bench/weights.py``), at tiny widths, in float32, kernels
off, on the CPU.

Stage by stage, each from the port's own inputs: the encoders' features;
the knots and slopes of the path the port's solve was handed and the
cold start z0 (the reference's fusion, reduction and path on the port's
features); every segment of the solve, redone from the port's own z at
the segment's first knot over the port's accepted steps (its step log),
each accepted step within the tolerances and the steps covering the
segment; the regressor on the port's z. Then whole windows
(a cold one and two carried) and a lane of the serving engine that opens
after the engine's first step, in carry and history mode, against the
reference's cold start.

Tolerances: features, path, head and a segment over the port's steps
are the same float32 products in another order (relative 1e-5 of the
stage's largest value, of the row's largest |z| for a segment). A whole
window is solved by two dopri5 solves at rtol 1e-4 that take different
steps (the reference starts every segment from ``dt0``; the port carries
its step across segments and reaches the knots in its own order of
operations), so they agree to a few times the tolerance: 5e-3 of the
largest pose and |z|. Whole windows
are made from frames and IMU at a tenth of their scale (the encoders at
their init are positively homogeneous: the features are a tenth too),
where this tiny field does not amplify rounding over a window as it does
at full scale (by ~1e-2 there).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models import pose_cde
from ode_vio_tpu_torch.ops.interpolation import cdeint_path, make_path
from ode_vio_tpu_torch.serving import StreamingEngine
from vio_bench.harness import BENCH_DIR, program_config
from vio_bench.reference.cde import cde_path, covered, replay, row_gaps
from vio_bench.reference.model import ReferenceModel
from vio_bench.tests.tiny import TINY_MODEL
from vio_bench.traffic import synthetic
from vio_bench.weights import make_weights

from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
EXACT, SOLVED = 1e-5, 5e-3
L = 11   # the configuration's seq_len: 10 knots, 9 segments and a zero-length first


def config():
    cfg = json.loads((BENCH_DIR / "configs" / "odevio-cde.json").read_text())
    cfg["model"].update(TINY_MODEL, use_kernels=False)
    return cfg


def windows(n, seed=7, scale=1.0):
    """``n`` consecutive windows of one session (images, IMU, clock): the
    last frame of one the first of the next, the clock from 1000 s; images
    and IMU times ``scale``."""
    cfg = config()["model"]
    rng = np.random.default_rng(seed)
    frames = scale * synthetic.frames(n * (L - 1) + 1, (cfg["img_h"], cfg["img_w"]), rng)
    imu = scale * synthetic.make_imu(n * (L - 1) + 1, rng).astype(np.float32)
    ts = 1000.0 + np.cumsum(rng.uniform(0.08, 0.2, n * (L - 1) + 1))
    return [(frames[i * (L - 1): i * (L - 1) + L],
             imu[10 * i * (L - 1): 10 * (i + 1) * (L - 1) + 1],
             ts[i * (L - 1): i * (L - 1) + L]) for i in range(n)]


@pytest.fixture(scope="module")
def models():
    cfg = config()
    weights = make_weights(cfg["model"], 2 ** 31 + 17, torch.device("cpu"))
    pc = program_config(cfg)
    model = DeepVIO(pc.model, pc.solver, pc.cde_solver_cfg).eval()
    model.load_state_dict(weights, strict=True)
    ref = ReferenceModel(cfg["model"], cfg["solver"], cfg["cde_solver"], weights)
    return model, ref, weights, pc


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def staged(models):
    """One cold window through the port, its solve's inputs, outputs and
    step log recorded at the core's call of the solver core (which is
    ``cdeint_path`` on ``make_path``'s path)."""
    model, ref, _, _ = models
    img, imu, ts = windows(1)[0]
    img, imu = t(img)[None], t(imu)[None]
    ts = t((ts - ts[0]).astype(np.float32))[None]
    calls = []
    solve = pose_cde.cdeint_batched

    def recorded(g, z0, knots, obs, eval_ts, kind, opts, train):
        assert not train
        log = []
        zs, _, stats = cdeint_path(g, z0, make_path(knots, obs, kind), eval_ts, opts, log=log)
        K = max(len(attempts) for attempts in log)
        steps = torch.zeros(eval_ts.shape[1], K, 2)
        for j, attempts in enumerate(log):
            if attempts:
                steps[j, :len(attempts)] = torch.stack(attempts, 1)[0]
        calls.append((z0, knots, obs, eval_ts, zs, steps))
        return zs, stats

    pose_cde.cdeint_batched = recorded
    try:
        with torch.no_grad():
            fv, fi = model.encode(img, imu)
            poses, _, _ = model.Pose_net(fv, fi, ts)
    finally:
        pose_cde.cdeint_batched = solve
    (z0, knots, obs, eval_ts, zs, steps), = calls
    return dict(img=img, imu=imu, ts=ts, fv=fv, fi=fi, poses=poses, z0=z0, knots=knots,
                obs=obs, eval_ts=eval_ts, zs=zs, steps=steps)


def rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("stage", ["visual", "inertial", "knots", "slopes", "z0", "segments",
                                   "head"])
def test_each_stage_from_the_ports_own_inputs(models, staged, stage):
    _, ref, _, _ = models
    s = staged
    with torch.no_grad():
        if stage in ("visual", "inertial"):
            want = ref.features(s["img"], s["imu"])[stage == "inertial"]
            assert rel(s["fv" if stage == "visual" else "fi"], want) < EXACT
            return
        knots, slopes, z_init = cde_path(ref, s["fv"], s["fi"], s["ts"], torch.tensor([True]))
        if stage == "knots":
            assert rel(s["knots"], knots) < EXACT
        elif stage == "slopes":
            gap = s["knots"][:, 1:] - s["knots"][:, :-1]
            got = (s["obs"][:, 1:] - s["obs"][:, :-1]) / gap[..., None]
            assert rel(got, slopes) < EXACT
        elif stage == "z0":
            assert rel(s["z0"], z_init) < EXACT
        elif stage == "segments":
            zs, E = s["zs"][0], s["zs"].shape[1]
            through = torch.cat([s["knots"][0, :1], s["eval_ts"][0]])
            start = torch.cat([s["z0"], zs[:-1]])
            want, ratio = replay(ref, start, s["steps"], s["knots"].expand(E, -1),
                                 slopes.expand(E, -1, -1))
            assert float(row_gaps(zs, want).max()) < EXACT
            assert float(ratio.max()) <= 1.0 + EXACT and float(ratio.max()) > 0.1
            assert bool(covered(s["steps"], through[:-1], through[1:]).all())
        else:
            assert rel(s["poses"], ref._regress(s["zs"])) < EXACT


@pytest.fixture(scope="module")
def carried(models):
    """Three windows of one session, cold then carried, through the port's
    pose core and the reference's, from the same features (the
    reference's)."""
    model, ref, _, _ = models
    out, carry_p, carry_r = [], None, None
    t0 = None
    for img, imu, ts in windows(3, seed=11, scale=0.1):
        t0 = ts[0] if t0 is None else t0
        clock = t((ts - t0).astype(np.float32))[None]
        with torch.no_grad():
            feats = ref.features(t(img)[None], t(imu)[None])
            got, carry_p, _ = model.Pose_net(*feats, clock, prev=carry_p)
            want, carry_r, _ = ref.core(*feats, clock, carry_r)
        out.append((got, want, carry_p, carry_r))
    return out


@pytest.mark.parametrize("window", [0, 1, 2])
def test_whole_windows_cold_then_carried(carried, window):
    got, want, carry_p, carry_r = carried[window]
    assert rel(got, want) < SOLVED
    assert rel(carry_p, carry_r) < SOLVED


@pytest.mark.parametrize("mode", ["carry", "history"])
def test_a_lane_opened_after_the_first_step_starts_cold(models, mode):
    """Session b opens after the engine has stepped session a: its first
    window starts as the reference's cold start, from
    ``tanh(initial(obs0))`` on its own clock (in history mode with a fresh
    buffer), and not from the zeroed lane it opened with."""
    model, ref, weights, pc = models
    if mode == "history":
        cfg = dataclasses.replace(pc.model, cde_streaming_mode="history", cde_history_cap=16)
        model = DeepVIO(cfg, pc.solver, pc.cde_solver_cfg).eval()
    eng = StreamingEngine(model, weights, max_sessions=2, fold_bn=False, device="cpu")
    a_wins, b_wins = windows(2, seed=3, scale=0.1), windows(1, seed=5, scale=0.1)
    a = eng.open_session()
    eng.step({a: a_wins[0]})
    b = eng.open_session()
    got = t(eng.step({a: a_wins[1], b: b_wins[0]})[b])
    img, imu, ts = b_wins[0]
    args = (t(img)[None], t(imu)[None], t((ts - ts[0]).astype(np.float32))[None])
    with torch.no_grad():
        want, _, _ = ref.window(*args)
        zero, _, _ = ref.window(*args, torch.zeros(1, ref.m["cde_hidden_dim"]),
                                torch.tensor([False]))
    assert rel(got, want[0]) < SOLVED
    assert rel(zero[0], got) > 0.5
