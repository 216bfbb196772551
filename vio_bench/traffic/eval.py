"""Whole-sequence evaluation, as ``cli.test --batch_runs`` runs it.

Parameters (``traffic/mixes/<mix>.json``, kind ``eval``):

* ``seqs``, ``n_frames``, ``raw_hw``, ``speed_scale``, ``tree_seed``: the
  synthetic KITTI tree the frozen writer writes (PNG frames at KITTI's raw
  size); it is written once per checkout under ``.vio_bench_cache/`` at a
  path named by these parameters, and read by every run;
* ``kitti_frames``: the source's frames in each of ``seqs``, which
  ``n_frames`` cuts (a record of the cut; nothing reads it);
* ``run_times``: the stochastic repeats, each a lane per sequence;
* ``fold_bn``: the infer callable's BatchNorm folding;
* ``write_workers``: the threads that compress the tree's PNGs;
* ``stage_every``: one in how many of the program's pose-core calls the
  check compares stage by stage.

Set-up builds one ``KittiEvaluator`` per repeat over the tree (frame
dropout at the configuration's ``eval_data_dropout``, repeat ``r`` drawing
from ``default_rng(seed + r)``, as ``cli.test`` draws from its seed) and
warms the infer callable and the decoder. The window runs ``eval_runs``
over them, pass after pass (a pass decodes every PNG again), until
``--seconds`` have gone; the pass under way then finishes and counts.

Correctness: the plain reference reads the tree itself (PNG decode with
zlib, the eval transform's resize), draws the same frame dropout, cuts the
same windows, and runs every lane's windows with its own carry. Compared,
each with the cell's limit: ``pose_gap``, the widest gap between the poses
the program returned in the window's passes and the reference's, over the
largest reference pose; ``feature_gap`` and ``core_gap``, the encoders and
the pose core each by itself on the calls :mod:`vio_bench.stages` samples
(every ``stage_every``-th, a mix parameter).
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from vio_bench import flops
from vio_bench.reference.images import load_frames
from vio_bench.stages import CoreCalls, Gap, core_gap
from vio_bench.traffic import synthetic
from vio_bench.weights import check_layout, make_weights

IMU_FREQ = 10


def tree_path(mix: dict) -> Path:
    """The tree's fixed place in the checkout, named by what it holds."""
    keys = ("seqs", "n_frames", "raw_hw", "speed_scale", "tree_seed")
    tag = hashlib.sha256(json.dumps({k: mix[k] for k in keys}).encode()).hexdigest()[:12]
    return Path.cwd() / ".vio_bench_cache" / f"eval_tree-{tag}"


def ensure_tree(mix: dict) -> Path:
    root = tree_path(mix)
    if (root / "complete").exists():
        return root
    part = root.with_name(root.name + ".partial")
    shutil.rmtree(part, ignore_errors=True)
    synthetic.make_kitti_tree(part, seqs=tuple(mix["seqs"]), n_frames=mix["n_frames"],
                              img_hw=tuple(mix["raw_hw"]), seed=mix["tree_seed"],
                              speed_scale=mix["speed_scale"], workers=mix["write_workers"])
    (part / "complete").write_text("")
    os.sync()   # no writeback of the fresh tree left to compete with the window
    shutil.rmtree(root, ignore_errors=True)
    part.rename(root)
    return root


class Lane:
    """One (repeat, sequence) lane as the reference cuts it: the kept
    frames after the dropout walk, and the windows over them."""

    def __init__(self, root: Path, seq: str, seq_len: int, dropout: float, rng):
        d = root / "sequences" / seq
        paths = sorted((d / "image_2").glob("*.png"))
        ts = np.loadtxt(d / "times.txt", dtype=np.float64).reshape(-1)
        import scipy.io as sio

        imu = np.asarray(sio.loadmat(root / "imus" / f"{seq}.mat")["imu_data_interp"],
                         np.float64)
        keep = list(range(len(paths)))
        n_rel, i = len(paths) - 1, 1
        if dropout > 0:
            # drop interior frame i+1 with probability ``dropout``, walking on
            while i < n_rel - 2:
                if rng.random() < dropout:
                    del keep[i + 1]
                    n_rel -= 1
                else:
                    i += 1
        rows = [np.arange(k * IMU_FREQ, (k + 1) * IMU_FREQ) for k in keep[:-1]]
        rows.append(np.asarray([keep[-1] * IMU_FREQ]))
        self.paths = [paths[k] for k in keep]
        self.ts = ts[keep]
        self.imu = imu[np.concatenate(rows)]
        self.windows = []   # (frame indices into self.paths, ts, imu, pad)
        n, start = len(keep), 0
        while start + seq_len < n:
            self._cut(start, seq_len, seq_len)
            start += seq_len - 1
        if start < n - 1:
            self._cut(start, n - start, seq_len)

    def _cut(self, start: int, length: int, seq_len: int) -> None:
        idx = list(range(start, start + length))
        ts = self.ts[idx].astype(np.float32)
        imu = self.imu[start * IMU_FREQ: (start + length - 1) * IMU_FREQ + 1].astype(np.float32)
        pad = seq_len - length
        if pad:
            # the tail window: the last gap repeated, the last IMU row repeated
            dt = float(ts[-1] - ts[-2]) if length > 1 else 0.1
            ts = np.concatenate([ts, ts[-1] + dt * np.arange(1, pad + 1, dtype=np.float32)])
            imu = np.concatenate([imu, np.repeat(imu[-1:], pad * IMU_FREQ, axis=0)], 0)
        self.windows.append((idx + [idx[-1]] * pad, ts, imu, pad))


class Served:
    def __init__(self, run):
        from ode_vio_tpu_torch.data.evaluation import KittiEvaluator
        from ode_vio_tpu_torch.data.native_loader import decode_batch
        from ode_vio_tpu_torch.models.deepvio import DeepVIO
        from ode_vio_tpu_torch.training.loop import make_infer_fn

        self.run = run
        mix, m = run.mix, run.config["model"]
        self.L, self.hw = m["seq_len"], (m["img_h"], m["img_w"])
        with run.spans("setup_tree"):
            self.root = ensure_tree(mix)
        with run.spans("setup_weights"):
            self.weights = make_weights(m, run.seed, run.device)
        cfg = run.program_config
        with torch.device("meta"):
            skeleton = DeepVIO(cfg.model, cfg.solver, cfg.cde_solver_cfg)
        check_layout(self.weights, skeleton.state_dict())
        self.cores = CoreCalls(type(skeleton.Pose_net), mix["stage_every"], run.seed)
        infer = make_infer_fn(skeleton, self.weights, fold_bn=mix["fold_bn"], device=run.device)
        self.log: List[torch.Tensor] = []

        def recording(img, imu, ts, carry=None):
            poses, carry = infer(img, imu, ts, carry)
            self.log.append(poses)
            return poses, carry
        recording.device = infer.device
        self.infer = recording
        self.dropout = run.config["data"]["eval_data_dropout"]
        self.evaluators = [
            KittiEvaluator(self.root, tuple(mix["seqs"]), self.L, self.hw, self.dropout,
                           rng=np.random.default_rng(run.seed % 2 ** 63 + r))
            for r in range(mix["run_times"])]
        with run.spans("setup_warmup"):
            lanes = len(mix["seqs"]) * mix["run_times"]
            first = decode_batch(self.evaluators[0].partitions[0].paths(0), self.hw)
            w = self.evaluators[0].partitions[0].assemble(0, first)
            put = lambda a: torch.from_numpy(np.stack([a] * lanes)).to(infer.device)  # noqa: E731
            _, carry = infer(put(w.imgs), put(w.imus), put(w.ts), None)
            infer(put(w.imgs), put(w.imus), put(w.ts), carry)[0].cpu()
        self.attempted = self.failed = 0
        self.passes = 0

    def warm_cycle(self) -> None:
        from ode_vio_tpu_torch.data.evaluation import eval_runs

        eval_runs(self.infer, self.evaluators)
        self.log.clear()
        for ev in self.evaluators:
            ev.timing.update(wall_s=0.0, decode_wait_s=0.0, steps=0, frames=0)

    def window(self, seconds: float) -> None:
        from ode_vio_tpu_torch.data.evaluation import eval_runs

        t0 = time.perf_counter()
        timing = self.evaluators[0].timing
        rates = []
        while True:
            t, f = time.perf_counter(), timing["frames"]
            with self.run.spans("eval_pass"), self.cores.watch():
                eval_runs(self.infer, self.evaluators)
            rates.append((timing["frames"] - f) / (time.perf_counter() - t))
            self.passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.elapsed = time.perf_counter() - t0
        print("vio_bench: frames/s by pass " + " ".join(f"{r:.2f}" for r in rates),
              file=sys.stderr, flush=True)
        self.frames = timing["frames"]
        self.steps = timing["steps"]
        self.run.counts.update(timing=dict(timing), passes=self.passes, elapsed_s=self.elapsed)
        self.attempted = self.passes * sum(len(ev.partitions) for ev in self.evaluators)
        print(f"vio_bench: {self.passes} passes, {self.frames} frames in {self.elapsed:.3f} s; "
              f"decode wait {timing['decode_wait_s']:.3f} of {timing['wall_s']:.3f} s",
              file=sys.stderr, flush=True)

    def end_to_end(self) -> dict:
        return {"eval_frames_per_s": self.frames / self.elapsed}

    def release(self) -> None:
        self.log = [p.cpu().numpy() for p in self.log]
        del self.infer
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        run, dev = self.run, self.run.device
        m = run.config["model"]
        if m["model_type"] not in ("ode-rnn", "rnn"):
            raise ValueError("the eval reference carries (L, lanes, F) states only")
        lanes = []
        for r in range(run.mix["run_times"]):
            # one generator per repeat, drawn from sequence after sequence
            rng = np.random.default_rng(run.seed % 2 ** 63 + r)
            lanes += [Lane(self.root, seq, self.L, self.dropout, rng) for seq in run.mix["seqs"]]
        n_steps = max(len(ln.windows) for ln in lanes)
        if len(self.log) != self.passes * n_steps or self.cores.calls != len(self.log):
            return False, {"pose_gap": {"value": None, "limit": run.limits["pose_gap"]},
                           "windows_per_pass": {"value": len(self.log) / max(self.passes, 1),
                                                "limit": n_steps},
                           "core_calls": {"value": self.cores.calls, "limit": len(self.log)}}
        ref = run.reference(self.weights)
        low = run.reference(self.weights, stand_in=True)
        features = Gap()
        worst, scale, evals, windows, finite = 0.0, 0.0, 0, 0, True
        carry = carry_low = None
        with torch.no_grad(), run.spans("reference"):
            frames = {}
            for w in range(n_steps):
                rows = [i for i, ln in enumerate(lanes) if w < len(ln.windows)]
                img, imu, ts = [], [], []
                for i in rows:
                    idx, t, u, _ = lanes[i].windows[w]
                    paths = [lanes[i].paths[k] for k in idx]
                    for p in paths:
                        if p not in frames:
                            frames[p] = load_frames([p], self.hw, dev)[0] - 0.5
                    img.append(torch.stack([frames[p] for p in paths]))
                    imu.append(torch.from_numpy(u))
                    ts.append(torch.from_numpy(t))
                ts = torch.stack(ts).to(dev)
                if carry is None:
                    ts = ts - ts[:, :1]   # a cold start runs on the window's clock
                img, imu = torch.stack(img), torch.stack(imu).to(dev)
                prev = None if carry is None else carry[:, rows]
                feats = ref.features(img, imu)
                poses, new, n = ref.core(*feats, ts, prev)
                evals += n
                windows += len(rows)
                if carry is None:
                    carry = new
                else:
                    carry[:, rows] = new
                stand_in = theirs = None
                if low is not None:
                    theirs = low.features(img, imu)
                    got_low, new_low, _ = low.core(
                        *theirs, ts, None if carry_low is None else carry_low[:, rows])
                    stand_in = got_low.double().cpu().numpy()
                    if carry_low is None:
                        carry_low = new_low
                    else:
                        carry_low[:, rows] = new_low
                want = poses.double().cpu().numpy()
                calls = [self.cores.taken[c] for c in range(w, len(self.log), n_steps)
                         if c in self.cores.taken]
                for r, i in enumerate(rows):
                    valid = self.L - 1 - lanes[i].windows[w][3]
                    for call in calls:
                        for x, part in enumerate(("visual", "inertial")):
                            program = call[("fv", "fi")[x]][i]
                            features.add(part, (program if theirs is None
                                                else theirs[x][r])[:valid], feats[x][r, :valid])
                    for p in range(self.passes):
                        got = (self.log[p * n_steps + w][i, :valid] if stand_in is None
                               else stand_in[r, :valid])
                        finite &= bool(np.isfinite(got).all())
                        worst = max(worst, float(np.abs(got - want[r, :valid]).max()))
                    scale = max(scale, float(np.abs(want[r, :valid]).max()))
            cores = core_gap(self.cores, ref, low)
        print(f"vio_bench: stages compared on {len(self.cores.taken)} of {self.cores.calls} "
              "core calls", file=sys.stderr, flush=True)
        bf16, f32 = flops.window_flops(m, windows * self.passes, evals * self.passes)
        run.counts.update(evals=evals * self.passes, bf16_flops=bf16, f32_flops=f32)
        compared = {"pose_gap": {"value": worst / scale if scale > 0 else None,
                                 "limit": run.limits["pose_gap"]},
                    "feature_gap": {"value": features.value(), "limit": run.limits["feature_gap"]},
                    "core_gap": {"value": cores.value(), "limit": run.limits["core_gap"]}}
        correct = finite and all(
            c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
        return correct, compared


def prepare(run) -> Served:
    return Served(run)
