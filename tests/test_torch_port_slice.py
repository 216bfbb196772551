"""The serving slice end to end: the JAX StreamingEngine and the port's,
on the same bridged weights (random BatchNorm statistics, folded by both
engines), two sessions over three windows with one opened late, so the
port's lanes see a cold start, a carried window, an idle replay and a
late fresh session. Poses within atol 1e-4 (f32 through encoders, nine
adaptive solves and the RNN stack, sums taken in another order);
per-lane truncated-solve counts equal."""

import dataclasses

import numpy as np
import pytest

from ode_vio_tpu.serving import StreamingEngine as JaxEngine
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.serving import StreamingEngine

from torch_port_helpers import configs, jax_model, window, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def serve(engine, schedule):
    """schedule: per window, the sessions to open first and the windows
    to serve {name: window}. Returns {name: [poses per served window]}."""
    sids, out = {}, {}
    for opens, served in schedule:
        for name in opens:
            sids[name] = engine.open_session()
        res = engine.step({sids[n]: w for n, w in served.items()})
        for n in served:
            out.setdefault(n, []).append(res[sids[n]])
    return out


SCHEDULE = [
    (["a"], {"a": window(1, 0.0)}),
    (["b"], {"a": window(2, 0.3), "b": window(11, 5.0)}),
    ([], {"a": window(3, 0.6), "b": window(12, 5.3)}),
    ([], {"b": window(13, 5.6)}),  # a idles: its lane replays, carry restored
]


@pytest.fixture(scope="module")
def reference():
    jc, tc = configs()
    model, variables = jax_model(jc)
    eng = JaxEngine(model, variables, max_sessions=2)
    eng.warmup(window(0))
    return tc, variables, serve(eng, SCHEDULE), eng.incomplete_by_lane()


@pytest.mark.parametrize("use_kernels", [None, True])
def test_streaming_engine_matches_jax(reference, use_kernels):
    """use_kernels=None resolves to the solver core on the CPU; True runs
    kernel K1's wrapper, i.e. its plain version on CPU tensors."""
    tc, variables, ref, ref_inc = reference
    cfg = dataclasses.replace(tc.model, use_kernels=use_kernels)
    model = DeepVIO(cfg, tc.solver)
    eng = StreamingEngine(model, from_jax_variables(variables, cfg),
                          max_sessions=2, device="cpu")
    eng.warmup(window(0))
    out = serve(eng, SCHEDULE)
    assert sorted(out) == sorted(ref)
    for name in ref:
        assert len(out[name]) == len(ref[name])
        for got, want in zip(out[name], ref[name]):
            assert got.shape == (2, 6) and np.isfinite(got).all()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(eng.incomplete_by_lane(), np.asarray(ref_inc))


def test_incomplete_counts_only_active_lanes():
    """A starved budget truncates every solve; only lanes serving a real
    window count (the JAX engine's contract, tests/test_serving.py)."""
    _, tc = configs()
    cfg = dataclasses.replace(tc.solver, max_steps=1)
    from ode_vio_tpu_torch.models.deepvio import create_model

    model = create_model(dataclasses.replace(tc, solver=cfg), device="cpu")
    eng = StreamingEngine(model, max_sessions=3, device="cpu")
    a, b = eng.open_session(), eng.open_session()
    eng.warmup(window(90))
    assert eng.incomplete() == 0
    per_window = 2 * 2  # L layers x (S-1) intervals, every solve truncated
    eng.step({a: window(91), b: window(95)})
    eng.step({a: window(92, 0.4)})
    assert eng.incomplete() == 3 * per_window
    np.testing.assert_array_equal(eng.incomplete_by_lane(), [2 * per_window, per_window, 0])
