"""The reduction of a profiler trace to busy time, idle gaps and device
time by name, on a hand-made trace, and the per-layer readers on it."""

import importlib.util
from types import SimpleNamespace

import pytest

from vio_bench.harness import BENCH_DIR
from vio_bench.trace import WINDOW_SPAN, TraceSummary


def X(name, ts, dur, cat, tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}


EVENTS = [
    X(WINDOW_SPAN, 1000, 1000, "user_annotation"),
    X("vio_bench.engine_step", 1000, 600, "user_annotation"),
    X("aten::copy_", 1050, 100, "cpu_op"),
    X("vio_bench.wait_for_due", 1650, 350, "user_annotation"),
    X("other thread", 1000, 1000, "cpu_op", tid=2),
    X("Memcpy HtoD (Pageable -> Device)", 1100, 100, "gpu_memcpy"),
    X("fused_ode_solve_kernel", 1150, 150, "kernel"),     # overlaps the copy
    X("fused_ode_solve_kernel", 1400, 100, "kernel"),
    X("conv", 1900, 200, "kernel"),                      # runs past the window
    X("before", 800, 100, "kernel"),                     # outside the window
]


def test_busy_gaps_and_names():
    t = TraceSummary(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # device busy: [1100, 1300] + [1400, 1500] + [1900, 2000] clipped
    assert t.busy_s == pytest.approx(400e-6)
    # idle gaps [1000,1100], [1300,1400] and [1500,1900], each labelled by the
    # innermost range of the window's thread open at its middle
    assert dict(t.gaps_by_host) == {"aten::copy_": pytest.approx(100e-6),
                                    "vio_bench.engine_step": pytest.approx(100e-6),
                                    "vio_bench.wait_for_due": pytest.approx(400e-6)}
    assert t.device_time_s("fused_ode_solve_kernel", cat="kernel") == pytest.approx(250e-6)
    assert t.device_time_s("HtoD", cat="gpu_memcpy") == pytest.approx(100e-6)
    assert t.count("fused_ode_solve_kernel") == 2
    b = t.breakdown()
    assert b["device_ops"][0] == ["fused_ode_solve_kernel", pytest.approx(250e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH_DIR / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_readers_on_the_trace():
    model = {"model_type": "ode-rnn", "v_f_len": 512, "i_f_len": 256, "ode_hidden_dim": 1024,
             "ode_fn_num_layers": 2}
    run = SimpleNamespace(trace=TraceSummary(EVENTS), config={"model": model},
                          counts={"steps": 2, "evals": 1000},
                          spans=SimpleNamespace(durations=lambda name: [0.2, 0.4]))
    assert reader("device_idle.serve")(run) == pytest.approx(60.0)
    assert reader("h2d_ms.serve")(run) == pytest.approx(0.05)
    assert reader("engine_step_ms.serve")(run) == pytest.approx(300.0)
    weights = 768 * 1024 + 1024 * 1024 + 1024 * 768
    assert reader("k1_roofline.serve")(run) == pytest.approx(
        100 * (1000 * 2 * weights / 67e12) / 250e-6)


def test_readers_without_their_records_report_nothing():
    run = SimpleNamespace(trace=None, config={"model": {}}, counts={},
                          spans=SimpleNamespace(durations=lambda name: []))
    for name in ("device_idle.serve", "h2d_ms.serve", "engine_step_ms.serve",
                 "k1_roofline.serve", "mfu.serve", "mfu.eval", "decode_wait.eval",
                 "device_idle.eval"):
        assert reader(name)(run) is None, name
