"""The per-layer readers of the program's own spans and counters
(``stage_ms.serve``, ``forward_ms.serve``, ``k1_useful.serve``,
``stage_ms.eval``) on a hand-made program record and benchmark spans:
program spans outside the benchmark's window spans are left out, a step's
replicas add up, and a record without them gives nothing."""

from types import SimpleNamespace

import pytest

from ode_vio_tpu_torch.utils import profiling
from vio_bench.harness import load_reader

Span, Count = profiling.Span, profiling.Count
READERS = ("stage_ms.serve", "forward_ms.serve", "k1_useful.serve", "stage_ms.eval")


def serve_step(t, step, gather, stack, replicas, readback):
    """One engine step's program spans from ``t``: ``replicas`` are (h2d,
    forward) seconds each."""
    out, name = [], "ode_vio.serve.step"
    a = t
    for what, took in [("serve.gather", gather), ("serve.stack", stack)] + [
            (w, x) for h2d, fwd in replicas for w, x in (("lanes.h2d", h2d),
                                                         ("lanes.forward", fwd))] + [
            ("lanes.readback", readback), ("serve.carry", 0.01)]:
        out.append(Span(f"ode_vio.{what}", a, a + took, name, step))
        a += took
    return out + [Span(name, t, a, None, step)]


def run_of(counts=None, **spans):
    return SimpleNamespace(spans=SimpleNamespace(by_name=spans), counts=counts or {})


@pytest.fixture
def program(monkeypatch):
    record = {"spans": [], "counts": []}
    monkeypatch.setattr(profiling, "record", lambda: record)
    return record


def test_serving_readers_keep_the_window_and_add_replicas(program):
    program["spans"] += (
        serve_step(5.0, 0, 0.5, 0.5, [(0.5, 0.5)], 0.5)            # warm-up: outside
        + serve_step(10.0, 1, 0.1, 0.2, [(0.05, 0.15), (0.05, 0.15)], 0.2)
        + serve_step(12.0, 2, 0.3, 0.1, [(0.1, 0.3)], 0.1)
        + serve_step(14.0, 3, 0.9, 0.9, [(0.9, 0.9)], 0.9))         # after the window
    program["counts"] += [Count("ode_vio.k1.row_evals", 10.3, 1000),
                          Count("ode_vio.k1.row_evals", 10.6, 1000),   # the second replica
                          Count("ode_vio.k1.row_evals", 12.5, 2000),
                          Count("ode_vio.k1.row_evals", 5.5, 9000),
                          Count("ode_vio.other", 12.5, 9000)]
    run = run_of({"evals": 1000}, engine_step=[(12.0, 13.0), (10.0, 11.0)])
    # staging: (0.1 + 0.2 + 0.05 + 0.05, 0.3 + 0.1 + 0.1), median 0.45 s
    assert load_reader("stage_ms.serve")(run) == pytest.approx(450.0)
    # forward and readback: (0.15 + 0.15 + 0.2, 0.3 + 0.1)
    assert load_reader("forward_ms.serve")(run) == pytest.approx(450.0)
    assert load_reader("k1_useful.serve")(run) == pytest.approx(25.0)


def test_eval_reader_takes_the_program_steps_inside_the_passes(program):
    def step(t, step, assemble, stage):
        return [Span("ode_vio.eval.decode_wait", t, t + 0.5, "ode_vio.eval.step", step),
                Span("ode_vio.eval.assemble", t + 0.5, t + 0.5 + assemble,
                     "ode_vio.eval.step", step),
                Span("ode_vio.eval.stage", t + 0.6, t + 0.6 + stage, "ode_vio.eval.step", step),
                Span("ode_vio.eval.forward", t + 0.8, t + 0.9, "ode_vio.eval.step", step),
                Span("ode_vio.eval.step", t, t + 1.0, None, step)]

    program["spans"] += (step(90.0, 0, 0.09, 0.09)        # the warm cycle: outside
                         + step(100.0, 1, 0.02, 0.03) + step(101.0, 2, 0.04, 0.05)
                         + step(102.0, 3, 0.06, 0.07))
    run = run_of(eval_pass=[(100.0, 103.0)])
    assert load_reader("stage_ms.eval")(run) == pytest.approx(90.0)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_record_gives_nothing(program, name):
    run = run_of({"evals": 1000}, engine_step=[(10.0, 11.0)],
                 eval_pass=[(10.0, 11.0)])
    assert load_reader(name)(run) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_its_own_record_gives_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "record")
    run = run_of({"evals": 1000}, engine_step=[(10.0, 11.0)],
                 eval_pass=[(10.0, 11.0)])
    assert load_reader(name)(run) is None
