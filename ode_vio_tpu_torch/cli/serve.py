"""Online serving entry point: ``python -m ode_vio_tpu_torch.cli.serve``.

The port's counterpart of ``ode_vio_tpu/cli/serve.py``. Streams
sequences through the model as a live odometry service would: windows
arrive in order, the hidden state carries across them, and each step's
wall-clock latency (decode-wait + device step + readback) is recorded.
Reports p50/p90/p99 step latency and steady-state throughput as one JSON
line on stdout, with the JAX package's keys, and writes the accumulated
KITTI-format trajectories.

One ``--val_seq`` entry serves that sequence alone; several entries are
multiplexed as concurrent sessions onto the lanes of one batched forward
through :class:`ode_vio_tpu_torch.serving.StreamingEngine`, the
multi-camera / multi-vehicle serving shape. The pipeline: folded
BatchNorm (models/fold.py), bf16 encoders, the warm-started adaptive
solve (kernel K1, or K2 for cde/rde, on the card), native C++ decode
prefetched one window ahead (data/native_loader.py). Runs on
``--device`` (default ``cuda``); with several sessions ``--eval_dp N``
splits their lanes over the first N cards, a replica of the model on
each. Under ``--multihost`` rank 0 of the job serves.

``main(argv, timing)``: a ``timing`` dict, where given, receives the
served run's wall seconds and the seconds spent waiting on decode.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ode_vio_tpu_torch.cli.flags import (
    build_model,
    build_parser,
    config_from_args,
    lane_devices,
    run_device,
)
from ode_vio_tpu_torch.data.evaluation import EvalPartition, kitti_eval
from ode_vio_tpu_torch.data.native_loader import Prefetcher
from ode_vio_tpu_torch.parallel.mesh import is_rank0
from ode_vio_tpu_torch.training.loop import make_infer_fn
from ode_vio_tpu_torch.utils import geometry as geo
from ode_vio_tpu_torch.utils.logging_utils import (
    setup_experiment_directories,
    setup_logger,
)


def _window_tensors(w, device):
    return tuple(torch.from_numpy(a[None]).to(device) for a in (w.imgs, w.imus, w.ts))


def main(argv=None, timing: Optional[dict] = None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = run_device(args)
    if not is_rank0():
        return None
    devices = lane_devices(args.eval_dp, device)
    dirs = setup_experiment_directories(
        cfg.save_dir, cfg.experiment_name + "_serve"
    )
    logger = setup_logger(f"serve_{cfg.experiment_name}", dirs["logs"])
    seq = cfg.data.val_seq[0]
    timing = {} if timing is None else timing

    model = build_model(cfg, device, logger, "serving")
    fold = not args.no_fold_bn
    if len(cfg.data.val_seq) > 1:
        return _serve_multi(cfg, model, fold, device, devices, dirs, logger, timing)

    infer = make_infer_fn(model, fold_bn=fold, device=device)

    part = EvalPartition(
        cfg.data.data_dir, seq, cfg.data.seq_len,
        (cfg.model.img_h, cfg.model.img_w),
    )

    # warm-up: the cold-start and the carried forward once on window 0,
    # so the first served window pays no kernel build or first-call cost;
    # truncated-solve counters reset afterwards so the report only counts
    # solves that actually served a frame
    w0 = _window_tensors(part[0], device)
    _, carry = infer(*w0, None)
    infer(*w0, carry)[0].cpu()
    infer.reset_incomplete()
    logger.info("warmed up; serving sequence %s (%d windows)", seq, len(part))

    pf = Prefetcher(part.img_hw)
    latencies = []
    chunks = []
    carry = None
    wait = 0.0
    t_start = time.perf_counter()
    try:
        pf.submit(0, part.paths(0))
        for i in range(len(part)):
            t0 = time.perf_counter()
            if i + 1 < len(part):
                pf.submit(i + 1, part.paths(i + 1))
            t = time.perf_counter()
            decoded = pf.get(i)
            wait += time.perf_counter() - t
            w = part.assemble(i, decoded)
            poses, carry = infer(*_window_tensors(w, device), carry)
            chunks.append(poses.cpu().numpy()[0, : w.valid])  # sync point
            latencies.append(time.perf_counter() - t0)
    finally:
        pf.close()
    wall = time.perf_counter() - t_start
    timing.update(wall_s=wall, decode_wait_s=wait)

    pose_est = np.concatenate(chunks, 0)
    est_mats = geo.accumulate_path(pose_est)
    out_path = dirs["poses"] / f"{seq}_pred.txt"
    geo.save_trajectory(est_mats, out_path)

    gt = np.asarray(part.seq.rel_poses[: len(pose_est)], np.float32)
    metrics = kitti_eval(pose_est, gt)

    lat_ms = np.sort(np.asarray(latencies)) * 1e3
    pct = lambda p: float(np.percentile(lat_ms, p))
    frames = int(pose_est.shape[0])
    report = {
        "seq": seq,
        "windows": len(part),
        "frames": frames,
        "latency_ms_p50": round(pct(50), 2),
        "latency_ms_p90": round(pct(90), 2),
        "latency_ms_p99": round(pct(99), 2),
        "frames_per_sec": round(frames / wall, 1),
        "t_rmse": round(float(metrics["t_rmse"]), 6),
        "trajectory": str(out_path),
    }
    if infer.incomplete() > 0:
        report["solver_incomplete"] = int(infer.incomplete())
    logger.info("serve report: %s", report)
    print(json.dumps(report))
    return report


def _serve_multi(cfg, model, fold_bn, device, devices, dirs, logger, timing):
    """Serve every ``--val_seq`` sequence as a concurrent session of one
    StreamingEngine, its lanes split over ``devices`` (``--eval_dp``; the
    lane count rounded up to a multiple, the spare lanes left free). The
    engine is warmed up on prototype windows before the clock starts, and
    the latency percentiles skip the first two steps, so both are
    steady-state."""
    from ode_vio_tpu_torch.serving import StreamingEngine

    seqs = list(cfg.data.val_seq)
    parts = {
        s: EvalPartition(cfg.data.data_dir, s, cfg.data.seq_len,
                         (cfg.model.img_h, cfg.model.img_w))
        for s in seqs
    }
    n = 1 if devices is None else len(devices)
    engine = StreamingEngine(model, max_sessions=-(-len(seqs) // n) * n, fold_bn=fold_bn,
                             device=device, devices=devices)
    sids = {s: engine.open_session() for s in seqs}
    w0 = parts[seqs[0]][0]
    engine.warmup((w0.imgs, w0.imus, w0.ts))
    logger.info("warmed up; serving %d sessions", len(seqs))
    pf = Prefetcher(parts[seqs[0]].img_hw)
    n_steps = max(len(p) for p in parts.values())

    def submit(step):
        for s in seqs:
            if step < len(parts[s]):
                pf.submit(step * len(seqs) + sids[s], parts[s].paths(step))

    chunks = {s: [] for s in seqs}
    latencies = []
    wait = 0.0
    t_start = time.perf_counter()
    try:
        submit(0)
        for step in range(n_steps):
            t0 = time.perf_counter()
            if step + 1 < n_steps:
                submit(step + 1)
            windows = {}
            metas = {}
            for s in seqs:
                if step >= len(parts[s]):
                    continue  # finished sequence: session idles
                t = time.perf_counter()
                decoded = pf.get(step * len(seqs) + sids[s])
                wait += time.perf_counter() - t
                w = parts[s].assemble(step, decoded)
                metas[s] = w
                windows[sids[s]] = (w.imgs, w.imus, w.ts)
            out = engine.step(windows)
            for s, w in metas.items():
                chunks[s].append(out[sids[s]][: w.valid])
            latencies.append(time.perf_counter() - t0)
    finally:
        pf.close()
    wall = time.perf_counter() - t_start
    timing.update(wall_s=wall, decode_wait_s=wait)

    per_seq = {}
    total_frames = 0
    for s in seqs:
        pose_est = np.concatenate(chunks[s], 0)
        total_frames += int(pose_est.shape[0])
        est_mats = geo.accumulate_path(pose_est)
        geo.save_trajectory(est_mats, dirs["poses"] / f"{s}_pred.txt")
        gt = np.asarray(parts[s].seq.rel_poses[: len(pose_est)], np.float32)
        per_seq[s] = round(float(kitti_eval(pose_est, gt)["t_rmse"]), 6)

    lat = np.sort(np.asarray(latencies)) * 1e3
    steady = lat if len(lat) <= 4 else np.sort(
        np.asarray(latencies[2:])) * 1e3
    pct = lambda p: float(np.percentile(steady, p))
    report = {
        "sessions": len(seqs),
        "steps": len(latencies),
        "frames": total_frames,
        "latency_ms_p50": round(pct(50), 2),
        "latency_ms_p90": round(pct(90), 2),
        "latency_ms_p99": round(pct(99), 2),
        "frames_per_sec": round(total_frames / wall, 1),
        "t_rmse": per_seq,
        "solver_incomplete": engine.incomplete(),
    }
    logger.info("serve report: %s", report)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
