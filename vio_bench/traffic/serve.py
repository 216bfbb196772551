"""Live serving: an open loop of camera sessions against ``StreamingEngine``.

Parameters (``traffic/mixes/<mix>.json``, kind ``serve``):

* ``sessions``: the sessions, and the engine's ``max_sessions``;
* ``camera_hz``, ``frame_drop``: each session's camera runs at
  ``camera_hz`` and loses each frame with probability ``frame_drop``; a
  window is ``seq_len`` kept frames, the first being the last of the
  session's previous window, and falls due at its last frame's camera
  time;
* ``schedule_seed``: the frame gaps and session phases form one fixed
  multiset, drawn from this seed; ``--seed`` only orders them (it
  permutes the gaps over all windows and the phases over the sessions), so
  every seed offers the same amount of work;
* ``pool_windows``: the distinct windows (float32 images at the model's
  size and their IMU samples) built at set-up from the frozen synthetic
  writer, one sequence with shared boundary frames; session ``s`` replays
  it from its own offset;
* ``fold_bn``: the engine's BatchNorm folding;
* ``stage_every``: one in how many engine steps the check compares stage
  by stage;
* ``drain_s``: how long past the window's close the loop keeps serving
  windows that fell due inside it; a window still unserved then has
  failed, and counts in the tail as late as it had waited.

Sessions started before the window opens, so their first windows fall due
across its first window-span; each opens its lane on its first window.
Every window due inside the window is attempted. The loop steps the
engine with the oldest due window of every session that has one; a
window's latency runs from its due time to its poses being back on the
host. How late the loop noticed each window (it looks between steps) is
printed on standard error.

Correctness: once the window has closed and the program is freed, the
plain reference recomputes every served window of every session, in
session order, from the same windows and the same weights, carrying its
own state. Compared, each with the cell's limit: ``pose_gap``, the widest
gap between the program's and the reference's poses over the largest
reference pose; ``feature_gap`` and ``core_gap``, the encoders and the pose
core each by itself on the engine steps :mod:`vio_bench.stages` samples
(every ``stage_every``-th); ``unserved_windows``, 0: a window never served
fails the run.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from vio_bench import flops
from vio_bench.stages import CoreCalls, Gap, core_gap
from vio_bench.traffic import synthetic
from vio_bench.weights import check_layout, make_weights

SESSION_CLOCK_BASE = 1000.0  # session clocks do not start at 0; the engine re-bases them


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile (0 < q < 1) by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


class Schedule:
    """Per session: its phase and its windows' frame gaps (in camera
    frames), hence each window's frame times and due time."""

    def __init__(self, mix: dict, seq_len: int, seconds: float, seed: int):
        S = mix["sessions"]
        period = 1.0 / mix["camera_hz"]
        keep = 1.0 - mix["frame_drop"]
        span = (seq_len - 1) * period / keep       # mean camera time of a window
        n_win = int(seconds / span * 1.5) + 8
        base = np.random.default_rng(mix["schedule_seed"])
        gaps = base.geometric(keep, size=S * n_win * (seq_len - 1))
        phases = (np.arange(S) + base.random()) / S * span
        rng = np.random.default_rng(seed % 2 ** 63)
        gaps = rng.permutation(gaps).reshape(S, n_win, seq_len - 1)
        phases = rng.permutation(phases)
        self.offsets = rng.integers(0, mix["pool_windows"], S)
        self.windows = []   # (due, session, ordinal, frame times (seq_len,) float64)
        for s in range(S):
            # the session's camera started before the window opened, so that
            # its first window falls due at ``phases[s]`` after the opening
            t = phases[s] - gaps[s, 0].sum() * period
            for j in range(n_win):
                times = t + np.concatenate([[0], np.cumsum(gaps[s, j])]) * period
                if times[-1] >= seconds:
                    break
                self.windows.append((float(times[-1]), s, j, times))
                t = times[-1]
        self.windows.sort(key=lambda w: w[0])


class Served:
    def __init__(self, run):
        from ode_vio_tpu_torch.models.deepvio import DeepVIO
        from ode_vio_tpu_torch.serving.engine import StreamingEngine

        self.run = run
        m = run.config["model"]
        mix = run.mix
        S, L = mix["sessions"], m["seq_len"]
        rng = np.random.default_rng(run.seed % 2 ** 63)
        with run.spans("setup_pool"):
            P = mix["pool_windows"]
            frames = synthetic.frames(P * (L - 1) + 1, (m["img_h"], m["img_w"]), rng)
            imu = synthetic.make_imu(P * (L - 1) + 1, rng).astype(np.float32)
            self.pool = [(frames[i * (L - 1): i * (L - 1) + L],
                          imu[10 * i * (L - 1): 10 * (i + 1) * (L - 1) + 1])
                         for i in range(P)]
        self.schedule = Schedule(mix, L, run.seconds, run.seed)
        with run.spans("setup_weights"):
            self.weights = make_weights(m, run.seed, run.device)
        cfg = run.program_config
        with torch.device("meta"):
            skeleton = DeepVIO(cfg.model, cfg.solver, cfg.cde_solver_cfg)
        check_layout(self.weights, skeleton.state_dict())
        self.cores = CoreCalls(type(skeleton.Pose_net), mix["stage_every"], run.seed)
        with run.spans("setup_engine"):
            self.engine = StreamingEngine(skeleton, self.weights, max_sessions=S,
                                          fold_bn=mix["fold_bn"], device=run.device)
            self.proto = self._window(0, 0, np.arange(L) * 0.1)
            self.engine.warmup(self.proto)
        self.lane: Dict[int, int] = {}
        self.served: Dict[int, list] = {s: [] for s in range(S)}  # (ordinal, ts, poses)
        self.latency: List[float] = []
        self.due: List[float] = []
        self.step_meta: List[dict] = []   # per engine step: lane -> (session, ordinal, due)
        self.unserved: List[float] = []
        self.lag: List[float] = []
        self.attempted = len(self.schedule.windows)
        self.failed = 0

    def _window(self, session: int, ordinal: int, times):
        img, imu = self.pool[(self.schedule.offsets[session] + ordinal) % len(self.pool)]
        return img, imu, SESSION_CLOCK_BASE + 37.0 * session + times

    def warm_cycle(self) -> None:
        self.engine.warmup(self.proto)

    def window(self, seconds: float) -> None:
        with self.cores.watch():
            self._loop(seconds)

    def _loop(self, seconds: float) -> None:
        spans, engine = self.run.spans, self.engine
        wins = self.schedule.windows
        queues: Dict[int, deque] = {}
        nxt, steps = 0, 0
        deadline = seconds + self.run.mix["drain_s"]
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while nxt < len(wins) and wins[nxt][0] <= now:
                due, s, j, times = wins[nxt]
                queues.setdefault(s, deque()).append((due, j, times))
                self.lag.append(now - due)
                nxt += 1
            batch, meta = {}, {}
            for s, q in queues.items():
                if q:
                    due, j, times = q.popleft()
                    if s not in self.lane:
                        self.lane[s] = engine.open_session()
                    batch[self.lane[s]] = self._window(s, j, times)
                    meta[self.lane[s]] = (s, j, due)
            if not batch:
                if nxt == len(wins):
                    break
                with spans("wait_for_due"):
                    time.sleep(max(0.0, min(wins[nxt][0] - now, 0.05)))
                continue
            if now > deadline:
                # never served: late by at least the time waited for them
                dues = ([d for q in queues.values() for d, _, _ in q]
                        + [d for _, _, d in meta.values()] + [w[0] for w in wins[nxt:]])
                self.unserved = [now - d for d in dues]
                self.failed = len(dues)
                break
            with spans("engine_step"):
                out = engine.step(batch)
            done = time.perf_counter() - t0
            steps += 1
            self.step_meta.append(meta)
            for lane, (s, j, due) in meta.items():
                self.latency.append(done - due)
                self.due.append(due)
                self.served[s].append((j, batch[lane][2], out[lane]))
        self.run.counts.update(steps=steps, windows_served=len(self.latency))
        lag_ms = sorted(x * 1e3 for x in self.lag)
        print(f"vio_bench: {len(self.latency)} of {self.attempted} windows served in {steps} "
              f"steps; the loop noticed a due window after {lag_ms[len(lag_ms) // 2]:.1f} ms "
              f"(median), {nearest_rank(lag_ms, 0.95):.1f} ms (p95), {lag_ms[-1]:.1f} ms (max)",
              file=sys.stderr, flush=True)
        # where the tail's spread comes from: the two halves' tails against
        # the mean step (a step's length sets the tail: a window waits for
        # the step under way, then rides the next)
        halves = [[x * 1e3 for x, d in zip(self.latency, self.due) if (d < seconds / 2) == h]
                  for h in (True, False)]
        step_ms = [x * 1e3 for x in spans.durations("engine_step")]
        if step_ms and all(halves):
            mean_step = sum(step_ms) / len(step_ms)
            print(f"vio_bench: p95 by half of the window {nearest_rank(halves[0], 0.95):.1f} / "
                  f"{nearest_rank(halves[1], 0.95):.1f} ms; engine step {mean_step:.1f} ms mean, "
                  f"{nearest_rank(step_ms, 0.5):.1f} median; p95 over the mean step "
                  f"{nearest_rank(self.latency, 0.95) * 1e3 / mean_step:.3f}",
                  file=sys.stderr, flush=True)

    def end_to_end(self) -> dict:
        return {"window_p95_ms": nearest_rank(self.latency + self.unserved, 0.95) * 1e3}

    def release(self) -> None:
        del self.engine
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        run = self.run
        m = run.config["model"]
        if m["model_type"] not in ("ode-rnn", "rnn"):
            raise ValueError("the serving check carries (L, sessions, F) states only")
        ref = run.reference(self.weights)
        low = run.reference(self.weights, stand_in=True)
        # the served windows of the sampled steps: (session, ordinal) -> (step, lane)
        sampled = {(s, j): (k, lane) for k, meta in enumerate(self.step_meta)
                   if k in self.cores.taken for lane, (s, j, _) in meta.items()}
        sessions = [s for s, w in self.served.items() if w]
        carry: Dict[int, torch.Tensor] = {}
        carry_low: Dict[int, torch.Tensor] = {}
        poses_gap, features = Gap(), Gap()
        evals, finite, by_ordinal = 0, True, []
        depth = max((len(self.served[s]) for s in sessions), default=0)
        dev = run.device
        with torch.no_grad(), run.spans("reference"):
            for k in range(depth):
                rows = [s for s in sessions if len(self.served[s]) > k]
                img, imu, ts, got = [], [], [], []
                for s in rows:
                    j, ts64, poses = self.served[s][k]
                    pool_img, pool_imu, _ = self._window(s, j, np.zeros(1))
                    t_off = self.served[s][0][1][0]
                    img.append(pool_img)
                    imu.append(pool_imu)
                    ts.append((ts64 - t_off).astype(np.float32))
                    got.append(poses)
                    finite &= bool(np.isfinite(poses).all())
                img = torch.from_numpy(np.stack(img)).to(dev)
                imu = torch.from_numpy(np.stack(imu)).to(dev)
                ts = torch.from_numpy(np.stack(ts)).to(dev)
                got = torch.from_numpy(np.stack(got)).to(dev)
                feats = ref.features(img, imu)
                # a session's lane starts from a zeroed carry
                prev = None if k == 0 else torch.stack([carry[s] for s in rows], 1)
                poses, new, n = ref.core(*feats, ts, prev)
                evals += n
                for i, s in enumerate(rows):
                    carry[s] = new[:, i]
                theirs = None
                if low is not None:
                    theirs = low.features(img, imu)
                    prev_low = None if k == 0 else torch.stack([carry_low[s] for s in rows], 1)
                    got, new_low, _ = low.core(*theirs, ts, prev_low)
                    for i, s in enumerate(rows):
                        carry_low[s] = new_low[:, i]
                for i, s in enumerate(rows):
                    key = (s, self.served[s][k][0])
                    if key in sampled:
                        step, lane = sampled[key]
                        call = self.cores.taken[step]
                        for x, part in enumerate(("visual", "inertial")):
                            program = call[("fv", "fi")[x]][lane]
                            features.add(part, program if theirs is None else theirs[x][i],
                                         feats[x][i])
                poses_gap.add("poses", got, poses)
                by_ordinal.append(float((got.double() - poses.double()).abs().max()))
            cores = core_gap(self.cores, ref, low)
        print("vio_bench: widest pose gap by window ordinal within a session: "
              + " ".join(f"{g:.3g}" for g in by_ordinal), file=sys.stderr, flush=True)
        print(f"vio_bench: stages compared on {len(self.cores.taken)} of {self.cores.calls} "
              f"core calls ({len(sampled)} served windows)", file=sys.stderr, flush=True)
        bf16, f32 = flops.window_flops(m, run.counts["windows_served"], evals)
        run.counts.update(evals=evals, bf16_flops=bf16, f32_flops=f32)
        compared = {name: {"value": g.value(), "limit": run.limits[name]} for name, g in
                    (("pose_gap", poses_gap), ("feature_gap", features), ("core_gap", cores))}
        if self.cores.calls != len(self.step_meta):
            # the core ran other than once a step: the sample is not the window's
            compared["core_calls"] = {"value": self.cores.calls, "limit": len(self.step_meta)}
        compared["unserved_windows"] = {"value": self.failed, "limit": 0}
        correct = finite and all(
            c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
        return correct, compared


def prepare(run) -> Served:
    return Served(run)
