"""Live serving of the neural-CDE core (``model_type`` cde, carry mode),
checked stage by stage.

The schedule, the pool, the loop and the timing are
:mod:`vio_bench.traffic.serve`'s, with the same mix parameters. Only the
correctness check differs: at random init the cde field amplifies rounding
over a window, and more so over a session's windows, so neither the
carried poses nor a whole window from the program's carry can tell a
sound float32 solve from one whose products run in TF32. Within one
segment of the path, started from the program's own state and stepped as
the program stepped, they can. So
the check follows the core stage by stage, each stage from the program's
own inputs and each against the cell's limit:

* ``feature_gap``: the encoders, as in :mod:`serve`, on every
  ``stage_every``-th engine step's served windows;
* ``path_gap``: the knots and per-segment slopes the program handed kernel
  K2, against the reference's fusion, reduction and path on the
  program's own features and the session's clock (a session's first window
  on its own clock); the z0 of each session's first window against the
  reference's cold start ``tanh(initial(obs0))``; the z0 of every later
  window against the program's own z at the last knot of the session's
  previous window (the engine's carry);
* ``segment_gap``: every segment of every served row of every K2 call in
  the window, recorded at K2's boundary (``cuda_kernels.fused_cde_solve``
  with its step log: z0, knots, slopes, the z it returned at each knot and
  each row's attempted steps). The reference redoes each segment from the
  program's z at the segment's first knot over the program's path with
  dopri5 steps of exactly the program's accepted ``(t, h)``
  (:mod:`vio_bench.reference.cde`), all segments as one batch of rows, so
  that only rounding differs: two solves that choose their own steps at
  rtol 1e-4 differ by a few 1e-3 of |z| where rounding decides a step,
  as a TF32 solve does. A segment's gap is the widest ``|program -
  reference|`` over the largest reference ``|z|`` of its row at its end
  knot: z starts at ``|z| <= 1`` in a session's cold first window and
  grows over its later ones, and one scale for the run would shrink the
  cold windows' gaps, where a lower precision shows most;
* ``step_error``: the widest error ratio of the program's accepted steps
  at the configuration's rtol and atol (the controller's RMS norm, which
  accepts at 1), recomputed by the reference in its replay: a solve at a
  looser tolerance takes steps the configuration would reject;
* ``uncovered_segments``, 0: the served rows' segments whose accepted
  steps do not run from the segment's start to its end as the controller
  takes them (each from where the last ended, the last onto the knot);
* ``head_gap``: the program's poses against the reference's regressor on
  the program's z at the knots;
* ``unserved_windows``, 0; ``truncated_segments``, 0: a served row's
  segment that ran out of K2's step budget left part of the solve out;
  ``core_calls``, 0: the engine steps whose pose-core call or K2 call is
  missing or extra (the stages are matched step by step).

With a control (``--control``), the control's stand-in computes each
stage in the program's place from the same program inputs, as
:func:`vio_bench.stages.core_gap` does, and each segment over the
program's steps.

The idle lanes' rows of a K2 call are recorded and not compared: the
engine drops their poses and restores their carry. The reference also
recomputes every served window on its own carried state, as :mod:`serve`
does, for the field evaluations the served windows need
(``run.counts``: ``evals``, ``bf16_flops``, ``f32_flops``, as
``mfu.serve`` reads them); its carried pose gap, which measures the
random field's amplification of rounding more than the program, goes to
standard error only.
"""

from __future__ import annotations

import inspect
import sys
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch

from vio_bench import flops
from vio_bench.harness import Failure
from vio_bench.reference.cde import cde_path, covered, replay, row_gaps
from vio_bench.stages import CoreCalls, Gap
from vio_bench.traffic.serve import Served


class K2Calls:
    """While watching, every call of ``cuda_kernels.fused_cde_solve`` (K2's
    boundary; ``ops/interpolation.py::cdeint_fused`` looks it up at each
    call), made with its step log: its z0, knots and slopes, the z it
    returned at each evaluation time, its truncated segments per row and
    its step log, cloned on the device."""

    def __init__(self):
        self.calls: List[dict] = []

    @contextmanager
    def watch(self):
        from ode_vio_tpu_torch.ops import cuda_kernels

        solve = cuda_kernels.fused_cde_solve

        def watched(layers, z0, path_ts, path_b, path_c, path_d, eval_ts, **kw):
            *out, steps = solve(layers, z0, path_ts, path_b, path_c, path_d, eval_ts,
                                log_steps=True, **kw)
            self.calls.append({"z0": z0.clone(), "knots": path_ts.clone(),
                               "slopes": path_b.clone(), "eval_ts": eval_ts.clone(),
                               "zs": out[0].clone(), "incomplete": out[4].clone(),
                               "steps": steps})
            return tuple(out)

        # the wrapper counts its launches on the module's attribute
        watched.launches, watched.last = solve.launches, solve.last
        cuda_kernels.fused_cde_solve = watched
        try:
            yield self
        finally:
            solve.launches, solve.last = watched.launches, watched.last
            cuda_kernels.fused_cde_solve = solve


class ServedCDE(Served):
    def __init__(self, run):
        m = run.config["model"]
        if m["model_type"] != "cde" or m["cde_streaming_mode"] != "carry" \
                or m["cde_interpolation"] != "linear":
            raise Failure("serve_cde checks the cde core in carry mode on a linear path")
        from ode_vio_tpu_torch.ops import cuda_kernels

        # refused before the window, so that no profiler is running yet
        if "log_steps" not in inspect.signature(cuda_kernels.fused_cde_solve).parameters:
            raise Failure("the program's K2 (cuda_kernels.fused_cde_solve) keeps no step "
                          "log, which the segment check replays")
        super().__init__(run)
        # every pose-core call is kept (the paths of every K2 call are
        # checked); the encoders are compared on every ``stage_every``-th
        every = run.mix["stage_every"]
        self.feature_steps = lambda k: k % every == run.seed % every  # noqa: E731
        self.cores = CoreCalls(self.cores.cls, 1, 0)
        self.k2 = K2Calls()

    def window(self, seconds: float) -> None:
        with self.cores.watch(), self.k2.watch():
            self._loop(seconds)

    def check(self):
        run = self.run
        m = run.config["model"]
        dev = run.device
        ref = run.reference(self.weights)
        low = run.reference(self.weights, stand_in=True)
        steps = len(self.step_meta)
        unmatched = abs(self.cores.calls - steps) + abs(len(self.k2.calls) - steps)
        sessions = [s for s, w in self.served.items() if w]
        finite = all(np.isfinite(p).all() for s in sessions for _, _, p in self.served[s])
        # each served window's clock, re-based to its session's first window
        clock = {(s, j): (ts64 - self.served[s][0][1][0]).astype(np.float32)
                 for s in sessions for j, ts64, _ in self.served[s]}
        features, path, head = Gap(), Gap(), Gap()
        segments = []   # per step: (z start, t0, t1, knots, slopes, steps, program's z at t1)
        sampled = {}    # (session, ordinal) -> (step, lane) whose features are compared
        truncated = 0
        with torch.no_grad(), run.spans("reference"):
            last_z: Dict[int, torch.Tensor] = {}
            for k, meta in enumerate(self.step_meta if not unmatched else []):
                call, k2 = self.cores.taken[k], self.k2.calls[k]
                lanes = sorted(meta)
                idx = torch.tensor(lanes, device=dev)
                cold = torch.tensor([meta[ln][0] not in last_z for ln in lanes], device=dev)
                ts = torch.from_numpy(np.stack([clock[meta[ln][:2]] for ln in lanes])).to(dev)
                fv, fi = call["fv"][idx].float(), call["fi"][idx].float()
                knots, slopes, z_init = cde_path(ref, fv, fi, ts, cold)
                z0, zs = k2["z0"][idx], k2["zs"][idx]
                if low is None:
                    got = (k2["knots"][idx], k2["slopes"][idx], z0)
                else:
                    got = cde_path(low, fv, fi, ts, cold)
                path.add("knots", got[0], knots)
                path.add("slopes", got[1], slopes)
                if bool(cold.any()):
                    path.add("z0", got[2][cold], z_init[cold])
                for i, ln in enumerate(lanes):
                    s = meta[ln][0]
                    if not bool(cold[i]):
                        path.add("carry", z0[i], last_z[s])
                    last_z[s] = zs[i, -1]
                # every segment of every served row, from the program's state
                through = torch.cat([k2["knots"][idx][:, :1], k2["eval_ts"][idx]], 1)
                E = zs.shape[1]
                starts = torch.cat([z0[:, None], zs[:, :-1]], 1)
                segments.append((starts, through[:, :-1], through[:, 1:],
                                 k2["knots"][idx, None].expand(-1, E, -1),
                                 k2["slopes"][idx, None].expand(-1, E, -1, -1),
                                 k2["steps"][idx], zs))
                truncated += int(k2["incomplete"][idx].sum())
                head.add("poses", call["poses"][idx] if low is None else low._regress(zs),
                         ref._regress(zs))
                if self.feature_steps(k):
                    sampled.update({meta[ln][:2]: (k, ln) for ln in lanes})
            segment_gap, step_error, uncovered = (self._segment_gap(segments, ref, low)
                                                  if segments else (None, None, None))
            evals, pose_gaps = self._carried(ref, features, sampled)
        print("vio_bench: widest carried pose gap by window ordinal within a session "
              "(the reference on its own carry; not compared): "
              + " ".join(f"{g:.3g}" for g in pose_gaps), file=sys.stderr, flush=True)
        print(f"vio_bench: stages compared on {steps} engine steps, {len(sampled)} served "
              f"windows' features", file=sys.stderr, flush=True)
        bf16, f32 = flops.window_flops(m, run.counts["windows_served"], evals)
        run.counts.update(evals=evals, bf16_flops=bf16, f32_flops=f32)
        compared = {name: {"value": v, "limit": run.limits[name]} for name, v in
                    (("feature_gap", features.value()), ("path_gap", path.value()),
                     ("segment_gap", segment_gap), ("step_error", step_error),
                     ("head_gap", head.value()))}
        compared["uncovered_segments"] = {"value": uncovered, "limit": 0}
        compared["core_calls"] = {"value": unmatched, "limit": 0}
        compared["truncated_segments"] = {"value": truncated, "limit": 0}
        compared["unserved_windows"] = {"value": self.failed, "limit": 0}
        correct = finite and all(
            c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
        return correct, compared

    def _segment_gap(self, segments, ref, low):
        """Over every (served row, segment) pair as one batch of rows, each
        redone from the program's state at its first knot over the
        program's accepted steps: the widest per-segment gap, the widest
        error ratio of an accepted step and the segments the accepted
        steps do not cover."""
        z, t0, t1, knots, slopes, steps, got = (torch.cat(x).flatten(0, 1)
                                                for x in zip(*segments))
        want, ratio = replay(ref, z, steps, knots, slopes)
        mine = got if low is None else replay(low, z, steps, knots, slopes)[0]
        gaps = row_gaps(mine, want)
        uncovered = int((~covered(steps, t0, t1)).sum())
        n = int((steps[..., 1] > 0).sum())
        print(f"vio_bench: {z.shape[0]} segments redone by the reference over the program's "
              f"{n} accepted steps; widest gap {float(gaps.max()):.3g}, median "
              f"{float(gaps.median()):.3g}; widest step error {float(ratio.max()):.6g}; "
              f"{uncovered} not covered", file=sys.stderr, flush=True)
        return float(gaps.max()), float(ratio.max()), uncovered

    def _carried(self, ref, features: Gap, sampled):
        """The reference over every served window on its own carry, by
        depth within the sessions: its field evaluations and, per depth, the
        widest pose gap against the program's; the encoders compared on the
        ``sampled`` windows ((session, ordinal) -> (step, lane)) into
        ``features``."""
        low = self.run.reference(self.weights, stand_in=True)
        dev = self.run.device
        sessions = [s for s, w in self.served.items() if w]
        carry: Dict[int, torch.Tensor] = {}
        evals, by_depth = 0, []
        depth = max((len(self.served[s]) for s in sessions), default=0)
        for k in range(depth):
            rows = [s for s in sessions if len(self.served[s]) > k]
            img, imu, ts, got = [], [], [], []
            for s in rows:
                j, ts64, poses = self.served[s][k]
                pool_img, pool_imu, _ = self._window(s, j, np.zeros(1))
                img.append(pool_img)
                imu.append(pool_imu)
                ts.append((ts64 - self.served[s][0][1][0]).astype(np.float32))
                got.append(poses)
            img = torch.from_numpy(np.stack(img)).to(dev)
            imu = torch.from_numpy(np.stack(imu)).to(dev)
            ts = torch.from_numpy(np.stack(ts)).to(dev)
            got = torch.from_numpy(np.stack(got)).to(dev)
            feats = ref.features(img, imu)
            prev = None if k == 0 else torch.stack([carry[s] for s in rows])
            poses, new, n = ref.core(*feats, ts, prev)
            evals += n
            for i, s in enumerate(rows):
                carry[s] = new[i]
            theirs = low.features(img, imu) if low is not None else None
            for i, s in enumerate(rows):
                key = (s, self.served[s][k][0])
                if key in sampled:
                    step, lane = sampled[key]
                    call = self.cores.taken[step]
                    for x, part in enumerate(("visual", "inertial")):
                        program = call[("fv", "fi")[x]][lane]
                        features.add(part, program if theirs is None else theirs[x][i],
                                     feats[x][i])
            by_depth.append(float((got.double() - poses.double()).abs().max()))
        return evals, by_depth


def prepare(run) -> ServedCDE:
    return ServedCDE(run)
