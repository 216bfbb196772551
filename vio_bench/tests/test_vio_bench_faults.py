"""A whole run of a tiny serving cell on the CPU, the harness's look for a
card skipped: sound, it is correct; with the timed path broken underneath,
``correct`` comes out false, once for each fault a serving cell can have
(one card: no exchange between chips to leave out). And each control, one
stage a precision lower than the configuration states (the program's
int8 trunk; the reference with its encoders in fp8, or its pose core in
bf16 or TF32, in the program's place), reads a far wider gap than the
sound run."""

import argparse
import time

import numpy as np
import pytest

from vio_bench import harness
from vio_bench.tests.tiny import loader, tiny_cell


def run(monkeypatch, breaker=None, control=None, config="odevio-odernn", seed=2 ** 31 + 3,
        sessions=3):
    monkeypatch.setattr(harness, "load_cell", loader(tiny_cell(config, sessions)))
    args = argparse.Namespace(workload="tiny", seed=seed, seconds=4.0, trace=0,
                              control=control, sessions=None)

    def hook(kind):
        if breaker is None:
            return kind

        class Broken:
            @staticmethod
            def prepare(r):
                served = kind.prepare(r)
                breaker(served.engine)
                return served
        return Broken

    return harness.run_cell(args, time.perf_counter(), device="cpu", prepare_hook=hook)


def state_unchanged(engine):
    infer = engine._infer

    def stuck(img, imu, ts, carry=None, active=None):
        poses, new = infer(img, imu, ts, carry, active=active)
        return poses, (new if carry is None else carry)
    for k in ("incomplete", "incomplete_by_lane", "reset_incomplete"):
        setattr(stuck, k, getattr(infer, k))
    engine._infer = stuck


def half_the_batch(engine):
    step = engine.step

    def half(windows):
        lanes = sorted(windows)
        kept = lanes[: max(1, len(lanes) // 2)]
        out = step({k: windows[k] for k in kept})
        return {k: out[k] if k in out else out[kept[0]] for k in lanes}
    engine.step = half


def answer_altered(engine):
    step, calls = engine.step, []

    def altered(windows):
        out = step(windows)
        calls.append(1)
        if len(calls) == 2:
            lane = sorted(out)[0]
            out[lane] = out[lane].copy()
            out[lane][3, 4] += 0.05 * float(np.abs(out[lane]).max())
        return out
    engine.step = altered


@pytest.mark.parametrize("config", ["odevio-odernn", "odevio-rnn"])
def test_a_sound_run_is_correct(monkeypatch, config):
    res = run(monkeypatch, config=config)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 4
    assert list(res)[-1] == "compared"
    assert set(res["metrics"]) == {"window_p95_ms", "setup_s"}


@pytest.mark.parametrize("breaker", [state_unchanged, half_the_batch, answer_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, breaker):
    res = run(monkeypatch, breaker, sessions=8)   # steps of several lanes
    assert not res["correct"]
    assert res["compared"]["pose_gap"]["value"] > res["compared"]["pose_gap"]["limit"]


@pytest.mark.parametrize("control,stage", [("int8", "feature_gap"), ("fp8", "feature_gap"),
                                           ("bf16-core", "core_gap"), ("tf32-core", "core_gap")])
def test_each_control_reads_far_wider_than_a_sound_run(monkeypatch, control, stage):
    sound = run(monkeypatch)["compared"]
    res = run(monkeypatch, control=control)
    assert not res["correct"]
    assert res["compared"][stage]["value"] > res["compared"][stage]["limit"]
    assert res["compared"][stage]["value"] > 30 * sound[stage]["value"]
    assert sound[stage]["value"] <= sound[stage]["limit"]


def test_the_eval_check_compares_each_stage(monkeypatch):
    from vio_bench.tests.tiny import tiny_eval_cell

    monkeypatch.setattr(harness, "load_cell", loader(tiny_eval_cell()))
    args = argparse.Namespace(workload="tiny", seed=2 ** 31 + 5, seconds=1.0, trace=0,
                              control=None, sessions=None)
    res = harness.run_cell(args, time.perf_counter(), device="cpu")
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == {"pose_gap", "feature_gap", "core_gap"}


# on the card: the program's own lower encoder path, and the pose core one
# and two precisions down (fp8 is read on the card once, in PERF.md)
CARD_CONTROLS = ("int8", "tf32-core", "bf16-core")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
@pytest.mark.parametrize("control", CARD_CONTROLS)
@pytest.mark.parametrize("cell", ["serve-odernn-live", "serve-rnn-s8", "eval-odernn-seq"])
def test_each_control_fails_the_cell_on_the_card(cell, control, seed):
    """A control at the cell's own size and load, a short window
    (``--control <name>``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = argparse.Namespace(workload=cell, seed=seed, seconds=8.0, trace=0,
                              control=control, sessions=None)
    res = harness.run_cell(args, time.perf_counter())
    assert not res["correct"], res["compared"]
