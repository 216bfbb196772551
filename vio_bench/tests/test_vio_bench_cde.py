"""The stage-by-stage check of cde serving (traffic kind ``serve_cde``) on a
tiny cell on the CPU (``tiny.py``'s widths, the ``odevio-cde``
configuration, K2's plain version behind its boundary): a sound run is
correct; the timed path broken in each stage is not, each in the stage it
breaks; each control reads far wider than a sound run; a program whose
K2 keeps no step log cannot be checked. On the card, each control fails
the cell ``serve-cde-s8``."""

import argparse
import copy
import json
import time

import pytest
import torch

from vio_bench import harness
from vio_bench.tests.tiny import TINY_MODEL

LIMITS = {"feature_gap": 1e-3, "path_gap": 1e-5, "segment_gap": 1e-5, "step_error": 1.01,
          "head_gap": 1e-5}


def tiny_cde_cell(sessions: int = 3) -> dict:
    cfg = json.loads((harness.BENCH_DIR / "configs" / "odevio-cde.json").read_text())
    cfg["model"].update(TINY_MODEL)
    mix = json.loads((harness.BENCH_DIR / "traffic" / "mixes" / "live-s8.json").read_text())
    mix.update(kind="serve_cde", sessions=sessions, pool_windows=4, drain_s=5, stage_every=2)
    return {"name": "tiny-cde", "config": "odevio-cde", "traffic": "live-s8",
            "chips": 1, "why": "test", "limits": dict(LIMITS), "config_file": cfg, "mix": mix}


def run(monkeypatch, breaker=None, control=None, seed=2 ** 31 + 3):
    cell = tiny_cde_cell()
    monkeypatch.setattr(harness, "load_cell", lambda name: copy.deepcopy(cell))
    args = argparse.Namespace(workload="tiny", seed=seed, seconds=4.0, trace=0,
                              control=control, sessions=None)

    def hook(kind):
        if breaker is None:
            return kind

        class Broken:
            @staticmethod
            def prepare(r):
                served = kind.prepare(r)
                breaker(monkeypatch, served.engine)
                return served
        return Broken

    return harness.run_cell(args, time.perf_counter(), device="cpu", prepare_hook=hook)


def bump(x: torch.Tensor, share: float = 0.05) -> torch.Tensor:
    """``x`` with one element moved by ``share`` of its largest value."""
    x = x.clone()
    x.view(-1)[x.numel() // 3] += share * float(x.abs().max())
    return x


def perturbed_features(monkeypatch, engine):
    from ode_vio_tpu_torch.models.encoders import ImageEncoder

    forward = ImageEncoder.forward
    monkeypatch.setattr(ImageEncoder, "forward", lambda *a, **kw: bump(forward(*a, **kw)))


def perturbed_slope(monkeypatch, engine):
    from ode_vio_tpu_torch.ops import interpolation

    make_path = interpolation.make_path
    monkeypatch.setattr(interpolation, "make_path",
                        lambda *a, **kw: make_path(*a, **kw)._replace(
                            b=bump(make_path(*a, **kw).b)))


def _k2(monkeypatch, change):
    from ode_vio_tpu_torch.ops import cuda_kernels

    solve = cuda_kernels.fused_cde_solve

    def broken(*a, **kw):
        return change(solve, a, kw)
    broken.launches, broken.last = solve.launches, solve.last
    monkeypatch.setattr(cuda_kernels, "fused_cde_solve", broken)


def segment_skipped(monkeypatch, engine):
    def change(solve, a, kw):
        zs, *rest = solve(*a, **kw)
        zs = zs.clone()
        zs[:, 5] = zs[:, 4]      # the sixth segment left out
        return (zs, *rest)
    _k2(monkeypatch, change)


def looser_rtol(monkeypatch, engine):
    _k2(monkeypatch, lambda solve, a, kw: solve(*a, **dict(kw, rtol=1e-2)))


def perturbed_regressor(monkeypatch, engine):
    from ode_vio_tpu_torch.models.common import PoseRegressor

    forward = PoseRegressor.forward
    monkeypatch.setattr(PoseRegressor, "forward", lambda *a, **kw: bump(forward(*a, **kw)))


def zeroed_cold_start(monkeypatch, engine):
    # sessions that open after the first step start from z0 = 0
    monkeypatch.setattr(engine, "_cold_mask", False)


def step_left_out(monkeypatch, engine):
    def change(solve, a, kw):
        *out, steps = solve(*a, **kw)
        steps = steps.clone()
        steps[:, 5, 0] = 0.0     # the sixth segment's first attempt forgotten
        return (*out, steps)
    _k2(monkeypatch, change)


BREAKERS = [(perturbed_features, "feature_gap"), (perturbed_slope, "path_gap"),
            (segment_skipped, "segment_gap"), (looser_rtol, "step_error"),
            (step_left_out, "uncovered_segments"), (perturbed_regressor, "head_gap"),
            (zeroed_cold_start, "path_gap")]


def test_a_sound_run_is_correct(monkeypatch):
    res = run(monkeypatch)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 4
    assert set(res["compared"]) == {"feature_gap", "path_gap", "segment_gap", "step_error",
                                    "head_gap", "uncovered_segments", "core_calls",
                                    "truncated_segments", "unserved_windows"}
    assert set(res["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("breaker,stage", BREAKERS, ids=[b.__name__ for b, _ in BREAKERS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, breaker, stage):
    res = run(monkeypatch, breaker)
    assert not res["correct"]
    assert res["compared"][stage]["value"] > res["compared"][stage]["limit"], res["compared"]


@pytest.mark.parametrize("control,stage", [("int8", "feature_gap"), ("fp8", "feature_gap"),
                                           ("bf16-core", "path_gap"), ("tf32-core", "path_gap"),
                                           ("bf16-core", "segment_gap"),
                                           ("tf32-core", "segment_gap")])
def test_each_control_reads_far_wider_than_a_sound_run(monkeypatch, control, stage):
    sound = run(monkeypatch)["compared"]
    res = run(monkeypatch, control=control)
    assert not res["correct"]
    assert res["compared"][stage]["value"] > res["compared"][stage]["limit"]
    assert res["compared"][stage]["value"] > 30 * sound[stage]["value"]
    assert sound[stage]["value"] <= sound[stage]["limit"]


def test_a_program_whose_k2_keeps_no_step_log_fails(monkeypatch):
    from ode_vio_tpu_torch.ops import cuda_kernels

    solve = cuda_kernels.fused_cde_solve

    # K2 as it was before it kept a step log
    def unlogged(layers, z0, path_ts, path_b, path_c, path_d, eval_ts, *, activation="tanh",
                 method="dopri5", rtol=1e-4, atol=1e-6, dt0=1e-4, max_steps=256,
                 safety=0.9, factor_min=0.2, factor_max=10.0):
        raise AssertionError("the check refuses the program before K2 runs")
    unlogged.launches, unlogged.last = solve.launches, solve.last
    monkeypatch.setattr(cuda_kernels, "fused_cde_solve", unlogged)
    with pytest.raises(harness.Failure, match="keeps no step log"):
        run(monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
@pytest.mark.parametrize("control", harness.CONTROLS)
def test_each_control_fails_the_cell_on_the_card(control, seed):
    """A control at serve-cde-s8's own size and load, a short window
    (``--control <name>``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = argparse.Namespace(workload="serve-cde-s8", seed=seed, seconds=8.0, trace=0,
                              control=control, sessions=None)
    res = harness.run_cell(args, time.perf_counter())
    assert not res["correct"], res["compared"]
