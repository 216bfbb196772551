"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each, any failure ends the run with a non-zero exit:
  env     the card, its power limit; TF32 off for matmuls and convs
  build   nvcc builds ode_vio_tpu_torch/csrc/fused_ode_solve.cu (sm_90a)
  kernel  K1 fused_ode_solve against its plain PyTorch version at the
          flagship field (softplus 768->1024->1024->768, dopri5, rtol 1e-2,
          atol 1e-6, max_steps 64): N = 3*4 rows, ragged N = 5, zero-length
          rows, per-row dt0, cases that force rejected steps and exhaust
          max_steps; y1, dt_final and the per-row counts compared; times
          with CUDA events
  slice   the flagship DeepVIO (seeded init) behind
          StreamingEngine(max_sessions=4, fold_bn=True): sessions opening
          at different windows, one idle for a window; K1 must launch once
          per frame interval (10 per step)
  core    the same windows through use_kernels=False (the solver core);
          poses must agree
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ode_vio_tpu_torch.config import flagship_config
from ode_vio_tpu_torch.models.deepvio import DeepVIO, create_model
from ode_vio_tpu_torch.ops import cuda_kernels
from ode_vio_tpu_torch.ops.mlp import init_mlp, ode_func_sizes
from ode_vio_tpu_torch.ops.solvers import get_tableau
from ode_vio_tpu_torch.serving import StreamingEngine

SEED = 0
SESSIONS = 4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def phase(which: str, **fields) -> None:
    print(json.dumps({"phase": which, **fields}), flush=True)


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median over ``runs`` of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def env() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("env", device=name, nvidia_smi=smi, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          tf32_matmul=False, tf32_cudnn=False)
    return name


def build() -> None:
    t = time.perf_counter()
    cuda_kernels.build()
    secs = time.perf_counter() - t
    ptxas = [ln.strip() for ln in cuda_kernels.build_output.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=round(secs, 3), source=str(cuda_kernels.SOURCE.name),
          ptxas=ptxas)


def field_problem(n: int, zero_rows, gen: torch.Generator, dev, gain: float = 1.0):
    """The flagship ODE field (its weights times ``gain``) and one frame
    interval per row."""
    m = flagship_config().model
    sizes = ode_func_sizes(m.f_len, m.ode_hidden_dim, m.ode_fn_num_layers)
    layers = [((gain * w).to(dev), (b + 0.01 * torch.randn(b.shape, generator=gen)).to(dev))
              for w, b in init_mlp(sizes, gen)]
    y0 = torch.tanh(torch.randn(n, m.f_len, generator=gen)).to(dev)
    t0 = (torch.rand(n, generator=gen) * 0.5).to(dev)
    t1 = t0 + (0.08 + 0.05 * torch.rand(n, generator=gen)).to(dev)
    t1[list(zero_rows)] = t0[list(zero_rows)]
    dt0 = (10 ** (-4 + 2.5 * torch.rand(n, generator=gen))).to(dev)  # warm starts
    return layers, y0, t0, t1, dt0


# (name, rows, zero-length rows, weight gain, dt0 override, solver overrides,
#  branches the case must reach). The flagship field at its own settings
# never rejects a step, so two cases steepen it (weights x3), start from
# dt0 = 0.1 and tighten rtol to force rejections; two starve the budget.
# A steeper field amplifies the summation-order differences, so the gain
# stays where y still agrees to 1e-4.
KERNEL_CASES = (
    ("n12_zero_rows", 12, (3, 7), 1.0, None, {}, ()),
    ("n5_ragged", 5, (2,), 1.0, None, {}, ()),
    ("n12_rejects", 12, (), 3.0, 0.1, {"rtol": 1e-4, "atol": 1e-7}, ("rejected",)),
    ("n12_budget_rejects", 12, (5,), 3.0, 0.1, {"rtol": 1e-4, "atol": 1e-7, "max_steps": 3},
     ("rejected", "incomplete")),
    ("n12_max_steps_1", 12, (0,), 1.0, 1e-4, {"max_steps": 1}, ("incomplete",)),
    ("n12_main", 12, (), 1.0, None, {}, ()),   # the main path's shape, timed below
)


def kernel_check(dev) -> dict:
    s = flagship_config().solver
    act = flagship_config().model.ode_activation_fn
    base = dict(activation=act, method=s.method, rtol=s.rtol, atol=s.atol,
                max_steps=s.max_steps, safety=s.safety, factor_min=s.factor_min,
                factor_max=s.factor_max)
    gen = torch.Generator().manual_seed(SEED)
    max_err, max_dt_rel, cases = 0.0, 0.0, {}
    for name, n, zero, gain, dt0_all, over, must_reach in KERNEL_CASES:
        layers, y0, t0, t1, dt0 = field_problem(n, zero, gen, dev, gain)
        if dt0_all is not None:
            dt0 = torch.full_like(dt0, dt0_all)
        kw = dict(base, **over)
        out = cuda_kernels.fused_ode_solve(layers, y0, t0, t1, dt0=dt0, **kw)
        ref = cuda_kernels.fused_ode_solve_plain(layers, y0, t0, t1, dt0, **kw)
        torch.cuda.synchronize()
        # f32 dot products summed in another order than cuBLAS's
        torch.testing.assert_close(out[0], ref[0], rtol=1e-4, atol=1e-5)
        # dt_final warm-starts the next interval. Where a row ran out of
        # budget it is the controller's proposal dt * ratio**(-1/5) after a
        # full step, and the ratio carries the stage sums' rounding: 1e-3.
        # Where a row landed on t1 it comes from the landing step, whose
        # error ratio is far below 1 (1e-5 and less at the flagship's
        # settings), i.e. at the level of that rounding: not compared.
        # Zero-length rows keep their dt0 exactly.
        inc, zero_len = ref[4].bool(), t1 == t0
        torch.testing.assert_close(out[1][inc], ref[1][inc], rtol=1e-3, atol=0.0)
        if not torch.equal(out[1][zero_len], dt0[zero_len]):
            raise AssertionError(f"{name}: zero-length rows changed their dt")
        counts = {}
        for k, what in ((2, "accepted"), (3, "rejected"), (4, "incomplete")):
            if not torch.equal(out[k], ref[k]):
                raise AssertionError(f"{name}: per-row {what} differ: "
                                     f"{out[k].tolist()} vs {ref[k].tolist()}")
            counts[what] = out[k].tolist()
        for what in must_reach:
            if sum(counts[what]) == 0:
                raise AssertionError(f"{name}: no row reached the {what} branch")
        if not torch.isfinite(out[0]).all():
            raise AssertionError(f"{name}: non-finite y1")
        max_err = max(max_err, float((out[0] - ref[0]).abs().max()))
        if inc.any():
            max_dt_rel = max(max_dt_rel, float(((out[1] - ref[1]).abs() / ref[1])[inc].max()))
        cases[name] = counts

    # time the main path's shape: 3 layers x 4 lanes, every row active
    ms = cuda_ms(lambda: cuda_kernels.fused_ode_solve(layers, y0, t0, t1, dt0=dt0, **kw))
    plain_ms = cuda_ms(lambda: cuda_kernels.fused_ode_solve_plain(
        layers, y0, t0, t1, dt0, **kw), runs=20)
    # bound: each input byte read once, each output byte written once; the
    # MLP evaluations this data needs (FSAL: 1 + 6 per step per row) at
    # 2 flops per weight per row, at the f32 CUDA-core peak
    tab = get_tableau(s.method)
    n_params = sum(w.numel() for w, _ in layers)
    steps = (out[2] + out[3]).cpu()
    evals = int((1 + (tab.num_stages - 1) * steps).sum()) if tab.fsal \
        else int((tab.num_stages * steps).sum())
    flops = evals * 2 * n_params
    nbytes = 4 * (sum(w.numel() + b.numel() for w, b in layers) + y0.numel() * 2 + n * 3 + n * 4)
    bound = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "flops_ms": flops / F32_FLOPS * 1e3}
    bound_by = "operations" if bound["flops_ms"] >= bound["bytes_ms"] else "bytes"
    phase("kernel", name="fused_ode_solve", cases=cases, max_abs_err=max_err,
          max_dt_final_rel_err_incomplete_rows=max_dt_rel, ms=ms, plain_ms=plain_ms, evals=evals,
          flops=flops, bytes=nbytes, **bound)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound.values()), "bound_by": bound_by}


def make_windows(cfg, gen: np.random.Generator, n_windows: int):
    m = cfg.model
    S = m.seq_len
    wins = {}
    for sess in range(SESSIONS):
        t = float(gen.uniform(0, 100))
        wins[sess] = []
        for _ in range(n_windows):
            imgs = gen.random((S, m.img_h, m.img_w, 3), np.float32) - 0.5
            imus = gen.standard_normal((10 * (S - 1) + 1, 6)).astype(np.float32)
            ts = t + np.cumsum(gen.uniform(0.08, 0.13, S))
            t = float(ts[-1])
            wins[sess].append((imgs, imus, ts))
    return wins


# per window: sessions to open first, then the sessions served
SCHEDULE = [([0, 1], [0, 1]), ([2], [0, 1, 2]), ([3], [0, 2, 3]), ([], [0, 1, 2, 3])]
IDLE = (2, 1)  # in window 2, session 1 idles


def serve(engine: StreamingEngine, wins, count_launches: bool):
    sids, nxt, poses, lat, launches = {}, {s: 0 for s in wins}, [], [], []
    for w, (opens, served) in enumerate(SCHEDULE):
        for s in opens:
            sids[s] = engine.open_session()
        before_idle = engine.hidden(sids[IDLE[1]]) if w == IDLE[0] else None
        batch = {sids[s]: wins[s][nxt[s]] for s in served}
        for s in served:
            nxt[s] += 1
        n0 = cuda_kernels.fused_ode_solve.launches
        t = time.perf_counter()
        out = engine.step(batch)
        lat.append(time.perf_counter() - t)
        launches.append(cuda_kernels.fused_ode_solve.launches - n0)
        for s in served:
            p = out[sids[s]]
            if p.shape != (10, 6) or not np.isfinite(p).all():
                raise AssertionError(f"window {w} session {s}: poses {p.shape} "
                                     f"finite={np.isfinite(p).all()}")
        poses.append({s: out[sids[s]] for s in served})
        if before_idle is not None and not torch.equal(before_idle, engine.hidden(sids[IDLE[1]])):
            raise AssertionError("the idle session's carry changed")
    if count_launches and launches != [10] * len(SCHEDULE):
        raise AssertionError(f"K1 launches per step {launches}, expected 10 each")
    return poses, lat, launches


def profile_step(engine: StreamingEngine, wins) -> None:
    """Device time by kernel over one served step (all four sessions, their
    first windows again), from torch.profiler; the idle share is the part
    of the step's wall time with no kernel running (one stream, so kernel
    times do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    batch = {sid: wins[sid][0] for sid in range(SESSIONS)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step(batch)
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    phase("profile", wall_ms=wall_ms, device_busy_ms=busy,
          idle_share=1.0 - busy / wall_ms if wall_ms else None,
          top_kernels_ms={k[:80]: v for k, v in top})


def slice_phases(dev) -> int:
    cfg = flagship_config()
    t = time.perf_counter()
    model = create_model(cfg, seed=SEED, device=dev)
    init_s = time.perf_counter() - t
    wins = make_windows(cfg, np.random.default_rng(SEED), len(SCHEDULE))
    proto = wins[0][0]

    engine = StreamingEngine(model, max_sessions=SESSIONS, fold_bn=True, device=dev)
    engine.warmup(proto)
    cuda_kernels.reset_launch_counts()          # the main path's run starts here
    poses, lat, per_step = serve(engine, wins, count_launches=True)
    launches = cuda_kernels.fused_ode_solve.launches
    phase("slice", init_s=init_s, windows=len(SCHEDULE), steps_launches=per_step,
          launches=launches, incomplete=engine.incomplete(),
          incomplete_by_lane=engine.incomplete_by_lane().tolist(),
          step_ms=[x * 1e3 for x in lat], p50_step_ms=statistics.median(lat) * 1e3)

    profile_step(engine, wins)

    with torch.device("meta"):
        core_model = DeepVIO(dataclasses.replace(cfg.model, use_kernels=False), cfg.solver)
    core = StreamingEngine(core_model, model.state_dict(), max_sessions=SESSIONS,
                           fold_bn=True, device=dev)
    core.warmup(proto)
    n0 = cuda_kernels.fused_ode_solve.launches
    core_poses, core_lat, _ = serve(core, wins, count_launches=False)
    if cuda_kernels.fused_ode_solve.launches != n0:
        raise AssertionError("use_kernels=False launched K1")
    # the bf16 encoders are the same on both paths; only the ODE solve
    # differs (kernel vs cuBLAS sums in f32), and its error control at
    # rtol 1e-2 lets the two land within 1e-3 of each other
    diff = max(float(np.abs(poses[w][s] - core_poses[w][s]).max())
               for w in range(len(SCHEDULE)) for s in poses[w])
    if diff > 1e-3:
        raise AssertionError(f"kernel vs solver-core poses differ by {diff}")
    phase("core", max_abs_pose_diff=diff, incomplete=core.incomplete(),
          step_ms=[x * 1e3 for x in core_lat],
          p50_step_ms=statistics.median(core_lat) * 1e3)
    return launches


def main() -> None:
    name = env()
    dev = torch.device("cuda", 0)
    build()
    k1 = kernel_check(dev)
    launches = slice_phases(dev)
    print(json.dumps({"kernels": [{
        "name": "fused_ode_solve", "route": "cuda",
        "source": "ode_vio_tpu_torch/csrc/fused_ode_solve.cu",
        "replaces": "ode_vio_tpu/ops/pallas_kernels.py:42",
        "launches": launches, "library_ms": None, **k1}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
