"""KITTI odometry evaluation: official segment metric, streaming
full-sequence inference with hidden-state carry, plots and pose dumps.

The port's copy of ``ode_vio_tpu/data/evaluation.py`` (the reference's
``src/data/KITTI_eval.py:30-284`` and the tester protocol of its
``scripts/test_model.py:91-153``). Windows go to the infer callable's
device (``infer.device``, set by ``training/loop.py::make_infer_fn``) as
torch tensors, and poses come back with ``.cpu().numpy()``; the carry
stays on the device from window to window. The JAX package's
``sharding`` argument, the lanes split over a data mesh, is ``devices``
here: a replica of the infer callable per device, each with its
contiguous block of lanes and its own carry (``parallel/lanes.py::
split_lanes``), the lanes padded to a multiple of the devices as
``pad_to`` pads them.

  * Eval windows are NON-overlapping with one shared boundary frame
    (stride seq_len-1, KITTI_eval.py:78-91). The ragged tail window is
    padded to the full window and the padded predictions are masked, so
    every inference call has the same shapes.
  * The hidden state carries across windows (KITTI_eval.py:124-160), so
    the effective temporal context is the entire driving sequence.
  * ``timing`` dicts (``KittiEvaluator.timing``) add up each stream's
    wall seconds, the seconds spent waiting on decode, the window steps
    and the scored frames.
  * While a profiler collects, each window step is the span
    ``ode_vio.eval.step`` holding ``eval.decode_wait`` (the wait that
    ``timing`` adds up), ``eval.assemble`` (the lanes' windows),
    ``eval.stage`` (stack and copy to the device) and ``eval.forward``
    (the call and the poses' readback) (``utils/profiling.py::span``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import time

import numpy as np
import torch

from ode_vio_tpu_torch.data.kitti import (
    IMU_FREQ,
    SequenceData,
    inject_frame_dropout,
    load_sequence,
)
from ode_vio_tpu_torch.parallel.lanes import split_lanes
from ode_vio_tpu_torch.utils import geometry as geo
from ode_vio_tpu_torch.utils.profiling import span

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
SEGMENT_STEP = 10  # evaluate every 10th start frame (KITTI_eval.py:258)
METRICS = ("t_rel", "r_rel", "t_rmse", "r_rmse")


def new_timing() -> dict:
    return {"wall_s": 0.0, "decode_wait_s": 0.0, "steps": 0, "frames": 0}


def _put(infer_fn: Callable, arrays) -> torch.Tensor:
    """Stack ``arrays`` into one tensor on the infer callable's device (the
    CPU for a callable without one)."""
    x = torch.from_numpy(np.stack(arrays, 0))
    device = getattr(infer_fn, "device", None)
    return x if device is None else x.to(device)


def _numpy(poses) -> np.ndarray:
    if isinstance(poses, torch.Tensor):
        return poses.cpu().numpy()
    return np.asarray(poses)


# ---------------------------------------------------------------------------
# Metric
# ---------------------------------------------------------------------------

def kitti_segment_errors(est_mats, gt_mats):
    """Per-(start, length) rotation/translation errors per meter over the
    official segment lengths (KITTI_eval.py:249-284)."""
    dist, speed = geo.trajectory_distances(gt_mats)
    errs = []
    for first in range(0, len(gt_mats), SEGMENT_STEP):
        for length in SEGMENT_LENGTHS:
            last = geo.last_frame_from_segment_length(dist, first, length)
            if last == -1 or last >= len(est_mats) or first >= len(est_mats):
                continue
            delta_gt = geo.relative_pose(gt_mats[first], gt_mats[last])
            delta_est = geo.relative_pose(est_mats[first], est_mats[last])
            r_err = geo.rotation_error(delta_est, delta_gt)
            t_err = geo.translation_error(delta_est, delta_gt)
            errs.append((first, r_err / length, t_err / length, length))
    return errs, np.asarray(speed)


def kitti_eval(pose_est: np.ndarray, pose_gt: np.ndarray) -> dict:
    """Full KITTI scoring of relative 6-DoF pose streams
    (KITTI_eval.py:223-246). Returns t_rel [%], r_rel [deg/100m],
    t_rmse [m], r_rmse [deg], plus the accumulated global trajectories."""
    t_rmse, r_rmse = geo.rmse_6dof(pose_est, pose_gt)
    est_mats = geo.accumulate_path(pose_est)
    gt_mats = geo.accumulate_path(pose_gt)
    errs, speed = kitti_segment_errors(est_mats, gt_mats)
    if errs:
        r_rel = float(np.mean([e[1] for e in errs]))
        t_rel = float(np.mean([e[2] for e in errs]))
    else:  # sequence shorter than the smallest segment
        r_rel = float("nan")
        t_rel = float("nan")
    return {
        "t_rel": t_rel * 100.0,
        "r_rel": r_rel / np.pi * 180.0 * 100.0,
        "t_rmse": t_rmse,
        "r_rmse": r_rmse / np.pi * 180.0,
        "est_global": est_mats,
        "gt_global": gt_mats,
        "speed": speed,
    }


# ---------------------------------------------------------------------------
# Streaming eval partition
# ---------------------------------------------------------------------------

@dataclass
class EvalWindow:
    imgs: np.ndarray        # (S, H, W, 3) float32 centered
    imus: np.ndarray        # (10*(S-1)+1, 6)
    ts: np.ndarray          # (S,)
    gts: np.ndarray         # (valid, 6)
    valid: int              # number of real (unpadded) pose transitions


class EvalPartition:
    """One full sequence split into boundary-sharing windows for streaming
    inference (KITTI_eval.py:30-110), with the ragged tail padded to the
    static window shape."""

    def __init__(
        self,
        data_dir,
        folder: str,
        seq_len: int = 11,
        img_hw=(256, 512),
        eval_dropout: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.seq_len = seq_len
        self.img_hw = tuple(img_hw)
        seq = load_sequence(data_dir, folder)
        if eval_dropout > 0.0:
            seq = inject_frame_dropout(
                seq, eval_dropout, rng or np.random.default_rng()
            )
        self.seq = seq
        self.windows: List[dict] = []
        n = seq.num_frames
        start = 0
        while start + seq_len < n:
            self._append(seq, start, seq_len)
            start += seq_len - 1
        if start < n - 1:  # ragged tail: pad to full window
            self._append(seq, start, n - start, pad_to=seq_len)

    def _append(self, seq: SequenceData, start: int, length: int,
                pad_to: Optional[int] = None):
        S = pad_to or length
        idx = np.arange(start, start + length)
        ts = seq.timestamps[idx].astype(np.float32)
        imus = seq.imus[
            start * IMU_FREQ : (start + length - 1) * IMU_FREQ + 1
        ].astype(np.float32)
        if pad_to is not None and length < S:
            # pad with synthetic strictly-ascending timestamps and repeated
            # last IMU row; padded transitions are masked out by `valid`.
            extra = S - length
            dt = float(ts[-1] - ts[-2]) if length > 1 else 0.1
            ts = np.concatenate(
                [ts, ts[-1] + dt * np.arange(1, extra + 1, dtype=np.float32)]
            )
            imus = np.concatenate(
                [imus, np.repeat(imus[-1:], extra * IMU_FREQ, axis=0)], 0
            )
        self.windows.append(
            {
                "paths": [seq.img_paths[k] for k in idx],
                "pad": 0 if pad_to is None else S - length,
                "ts": ts,
                "imus": imus,
                "gts": np.asarray(
                    seq.rel_poses[start : start + length - 1], np.float32
                ),
            }
        )

    def __len__(self) -> int:
        return len(self.windows)

    def paths(self, i: int) -> List:
        """Image paths of window ``i`` (for async prefetch submission)."""
        return self.windows[i]["paths"]

    def assemble(self, i: int, imgs: np.ndarray) -> EvalWindow:
        """Build the padded EvalWindow from already-decoded [0,1] images of
        ``paths(i)`` — the decode can run ahead on the native prefetcher
        while the device computes the previous window."""
        w = self.windows[i]
        imgs = imgs - 0.5
        if w["pad"]:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], w["pad"], axis=0)], 0
            )
        return EvalWindow(
            imgs=imgs.astype(np.float32),
            imus=w["imus"],
            ts=w["ts"],
            gts=w["gts"],
            valid=self.seq_len - 1 - w["pad"],
        )

    def __getitem__(self, i: int) -> EvalWindow:
        from ode_vio_tpu_torch.data.native_loader import decode_batch

        return self.assemble(i, decode_batch(self.paths(i), self.img_hw))


# ---------------------------------------------------------------------------
# Tester
# ---------------------------------------------------------------------------

def stream_eval_lanes(
    infer_fn: Callable,
    parts: Sequence[EvalPartition],
    pad_to: Optional[int] = None,
    timing: Optional[dict] = None,
    devices: Optional[Sequence] = None,
) -> List[dict]:
    """Stream a set of eval partitions as parallel batch lanes through one
    batched forward per window step and score each with the official
    KITTI metric.

    The lanes replace the reference's strictly sequential eval loop
    (KITTI_eval.py:166-170) AND its sequential ``--run_times`` repetition
    loop (test_model.py:101-128; see :func:`eval_runs`). ``pad_to`` rounds
    the lane count up to a multiple of it; padded lanes replay lane data
    already decoded (zero extra host decode) and their outputs are
    discarded.

    Exhausted lanes replay their last window; their outputs are discarded.
    Window ``w + 1`` decodes on the prefetcher's threads while the device
    runs window ``w``. ``timing`` (a :func:`new_timing` dict), where given,
    adds up the stream's wall and decode-wait seconds, steps and frames.
    ``devices`` splits the lanes over replicas of ``infer_fn`` (a
    ``make_infer_fn`` callable, whose truncated-solve counts then include
    the replicas'), and ``pad_to`` defaults to their number. Returns one
    ``kitti_eval`` dict per partition, in order.
    """
    from ode_vio_tpu_torch.data.native_loader import Prefetcher

    if devices is not None:
        infer_fn = split_lanes(infer_fn, devices)
        pad_to = pad_to or len(devices)
    parts = list(parts)
    n_real = len(parts)
    # lane -> source partition index; padded lanes alias the last partition
    # and reuse its assembled window (no duplicate decode)
    srcs = list(range(n_real))
    if pad_to is not None and n_real % pad_to != 0:
        srcs += [n_real - 1] * (-n_real % pad_to)

    n_windows = max(len(p) for p in parts)
    carry = None
    chunks: List[List[np.ndarray]] = [[] for _ in parts]
    pf = Prefetcher(parts[0].img_hw)
    timing = new_timing() if timing is None else timing

    def submit(w: int) -> None:
        # one ticket per step: all real lanes' window paths concatenated
        paths = []
        for p in parts:
            paths.extend(p.paths(min(w, len(p) - 1)))
        pf.submit(w, paths)

    t_start = time.perf_counter()
    try:
        submit(0)
        for w in range(n_windows):
            with span("ode_vio.eval.step"):
                if w + 1 < n_windows:
                    submit(w + 1)
                with span("ode_vio.eval.decode_wait"):
                    t = time.perf_counter()
                    decoded = pf.get(w)
                    timing["decode_wait_s"] += time.perf_counter() - t
                with span("ode_vio.eval.assemble"):
                    ws, off = [], 0
                    for p in parts:
                        i = min(w, len(p) - 1)
                        n = len(p.paths(i))
                        ws.append(p.assemble(i, decoded[off : off + n]))
                        off += n
                with span("ode_vio.eval.stage"):
                    imgs = _put(infer_fn, [ws[s].imgs for s in srcs])
                    imus = _put(infer_fn, [ws[s].imus for s in srcs])
                    ts = _put(infer_fn, [ws[s].ts for s in srcs])
                with span("ode_vio.eval.forward"):
                    poses, carry = infer_fn(imgs, imus, ts, carry)
                    poses = _numpy(poses)
                for lane, p in enumerate(parts):
                    if w < len(p):
                        chunks[lane].append(poses[lane, : ws[lane].valid])
    finally:
        pf.close()
    timing["wall_s"] += time.perf_counter() - t_start
    timing["steps"] += n_windows
    results = []
    for lane, p in enumerate(parts):
        pose_est = np.concatenate(chunks[lane], 0)
        timing["frames"] += len(pose_est)
        pose_gt = np.asarray(p.seq.rel_poses[: len(pose_est)], np.float32)
        results.append(kitti_eval(pose_est, pose_gt))
    return results


def eval_runs(
    infer_fn: Callable,
    evaluators: Sequence["KittiEvaluator"],
    pad_to: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> List[List[dict]]:
    """Run SEVERAL stochastic eval repeats in one batched stream.

    The reference repeats the full evaluation ``--run_times`` times
    sequentially to average over the random frame-dropout draws
    (test_model.py:101-128). Here every (run, sequence) pair becomes one
    batch lane of a single streaming forward, so the repeats amortise
    into the batch; ``devices`` splits the lanes over replicas as
    :func:`stream_eval_lanes` does. Each evaluator's ``.results`` is filled
    so plots/pose dumps keep working per run, and the first evaluator's
    ``.timing`` holds the stream's.

    Returns ``all_runs[run][seq]`` metric dicts, the shape
    ``summarize_runs`` expects.
    """
    lanes: List[EvalPartition] = []
    for ev in evaluators:
        lanes.extend(ev.partitions)
    flat = stream_eval_lanes(infer_fn, lanes, pad_to=pad_to,
                             timing=evaluators[0].timing, devices=devices)
    out: List[List[dict]] = []
    off = 0
    for ev in evaluators:
        n = len(ev.partitions)
        ev.results = flat[off : off + n]
        out.append([{k: r[k] for k in METRICS} for r in ev.results])
        off += n
    return out


class KittiEvaluator:
    """Runs streaming full-sequence inference and the KITTI metric per
    validation sequence (KITTI_eval.py:113-220).

    ``infer_fn(imgs, imus, ts, carry) -> (poses, carry)`` is any callable
    with the DeepVIO shape contract (``make_infer_fn``'s, or a test's);
    its inputs are tensors on ``infer_fn.device`` (the CPU where it has
    none), its poses a tensor or an array. ``timing`` adds up the wall and
    decode-wait seconds, steps and frames of every stream it ran.
    """

    def __init__(
        self,
        data_dir,
        val_seqs: Sequence[str] = ("05", "07", "10"),
        seq_len: int = 11,
        img_hw=(256, 512),
        eval_dropout: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.val_seqs = list(val_seqs)
        self.partitions = [
            EvalPartition(data_dir, s, seq_len, img_hw, eval_dropout, rng)
            for s in self.val_seqs
        ]
        self.results: List[dict] = []
        self.timing = new_timing()

    def eval_sequence(self, infer_fn: Callable, part: EvalPartition) -> dict:
        """Streaming single-sequence eval with double-buffered decode:
        window i+1 decodes on the native prefetcher's C++ threads while
        the device runs window i (the host blocks on the poses' readback,
        the decode proceeds concurrently)."""
        from ode_vio_tpu_torch.data.native_loader import Prefetcher

        pf = Prefetcher(part.img_hw)
        t_start = time.perf_counter()
        try:
            carry = None
            chunks = []
            pf.submit(0, part.paths(0))
            for i in range(len(part)):
                with span("ode_vio.eval.step"):
                    if i + 1 < len(part):
                        pf.submit(i + 1, part.paths(i + 1))
                    with span("ode_vio.eval.decode_wait"):
                        t = time.perf_counter()
                        decoded = pf.get(i)
                        self.timing["decode_wait_s"] += time.perf_counter() - t
                    with span("ode_vio.eval.assemble"):
                        w = part.assemble(i, decoded)
                    with span("ode_vio.eval.stage"):
                        x = [_put(infer_fn, [a]) for a in (w.imgs, w.imus, w.ts)]
                    with span("ode_vio.eval.forward"):
                        poses, carry = infer_fn(*x, carry)
                        chunks.append(_numpy(poses)[0, : w.valid])
        finally:
            pf.close()
        self.timing["wall_s"] += time.perf_counter() - t_start
        self.timing["steps"] += len(part)
        pose_est = np.concatenate(chunks, 0)
        self.timing["frames"] += len(pose_est)
        pose_gt = np.asarray(part.seq.rel_poses[: len(pose_est)], np.float32)
        return kitti_eval(pose_est, pose_gt)

    def eval_batched(self, infer_fn: Callable,
                     devices: Optional[Sequence] = None) -> List[dict]:
        """Stream ALL validation sequences together, one sequence per batch
        lane, in place of the reference's one-sequence-at-a-time batch-1
        loop (KITTI_eval.py:166-170): one batched forward serves every
        window step of every sequence (split over ``devices`` as
        :func:`stream_eval_lanes` splits it). Exhausted lanes replay their
        last window; their outputs are discarded."""
        self.results = stream_eval_lanes(infer_fn, self.partitions,
                                         timing=self.timing, devices=devices)
        return [{k: r[k] for k in METRICS} for r in self.results]

    def eval(self, infer_fn: Callable, batched: bool = True) -> List[dict]:
        if batched and len(self.partitions) > 1:
            return self.eval_batched(infer_fn)
        self.results = [
            self.eval_sequence(infer_fn, p) for p in self.partitions
        ]
        return [{k: r[k] for k in METRICS} for r in self.results]

    def generate_plots(self, save_dir, tag="") -> None:
        """Trajectory XZ plots per sequence (KITTI_eval.py:202-212,
        287-338)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for seq, res in zip(self.val_seqs, self.results):
            gt = np.asarray([P[[0, 2], 3] for P in res["gt_global"]])
            est = np.asarray([P[[0, 2], 3] for P in res["est_global"]])
            fig, ax = plt.subplots(figsize=(6, 6), dpi=100)
            ax.plot(gt[:, 0], gt[:, 1], "r-", label="Ground Truth")
            ax.plot(est[:, 0], est[:, 1], "b-", label="Ours")
            ax.plot(0, 0, "ko", label="Start")
            ax.set_xlabel("x (m)")
            ax.set_ylabel("z (m)")
            ax.set_aspect("equal")
            ax.legend(loc="upper right", fontsize=9)
            ax.set_title(f"seq {seq} trajectory")
            fig.savefig(save_dir / f"{seq}_path_2d{tag}.png",
                        bbox_inches="tight", pad_inches=0.1)
            plt.close(fig)

    def save_text(self, save_dir) -> None:
        """KITTI-format predicted/gt trajectory dumps
        (KITTI_eval.py:214-220)."""
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for seq, res in zip(self.val_seqs, self.results):
            geo.save_trajectory(res["est_global"], save_dir / f"{seq}_pred.txt")
            geo.save_trajectory(res["gt_global"], save_dir / f"{seq}_gt.txt")


def summarize_runs(all_runs: List[List[dict]], val_seqs: Sequence[str]) -> str:
    """mean +/- std across repeated stochastic-dropout eval runs
    (test_model.py:134-153 summary protocol)."""
    lines = []
    for i, seq in enumerate(val_seqs):
        per_metric = {
            k: np.asarray([run[i][k] for run in all_runs])
            for k in METRICS
        }
        stats = ", ".join(
            f"{k}: {v.mean():.4f} +- {v.std():.4f}" for k, v in per_metric.items()
        )
        lines.append(f"seq {seq}: {stats}")
    return "\n".join(lines)
