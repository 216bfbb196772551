"""PoseRDE, the neural rough-differential-equation pose core (log-ODE
method) (counterpart of ``ode_vio_tpu/models/pose_rde.py``).

The fused features are reduced to ``rde_reduced_dim`` channels and
augmented with their times; the path is compressed into depth-2
log-signature windows (``ops/logsig.py``), and a CDE driven by the
compressed, piecewise-linear path integrates the latent state through
the window's feature times. Streaming modes (``rde_streaming_mode``) as
for PoseCDE; in ``history`` mode the ring buffer holds compressed-path
knots, appended as a running sum of the windows' log-signatures so that
the buffered path stays continuous. The solve runs kernel K2 (adaptive
options only) or the solver core, and train mode runs the training regime
through the bounded solve and never K2, as in PoseCDE. ``ModelConfig.
adjoint`` does not reach this core: JAX's PoseRDE trains through the
bounded solve whatever it says. Every carry leaf has its lane on axis 0.
``cold`` marks lanes that start afresh beside a carry, as for PoseCDE.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import ModelConfig, SolverConfig
from ode_vio_tpu_torch.models.common import Carry, MLPField, PoseRegressor
from ode_vio_tpu_torch.models.fusion import FusionModule
from ode_vio_tpu_torch.models.pose_cde import (cde_solver, cold_lanes, collapse_prefix,
                                               solve_stats)
from ode_vio_tpu_torch.ops.logsig import logsig_dim, logsig_windows
from ode_vio_tpu_torch.ops.mlp import cde_func_sizes


class PoseRDE(nn.Module):
    carry_lane_axis = 0  # z (B, H), or the history dict of (B, ...) leaves
    cold_mask = True     # forward takes ``cold``, as PoseCDE's

    def __init__(self, cfg: ModelConfig, solver: SolverConfig):
        super().__init__()
        self.cfg = cfg
        self.solver = solver
        F, H = cfg.f_len, cfg.cde_hidden_dim
        d = cfg.rde_reduced_dim + 1  # + time
        self.sig_dim = logsig_dim(d, cfg.logsig_depth)
        self.fuse = FusionModule(F, cfg.fuse_method)
        self.reduction_net = nn.Linear(F, cfg.rde_reduced_dim)
        self.cde_func = MLPField(cde_func_sizes(self.sig_dim, H, cfg.cde_fn_num_layers),
                                 cfg.cde_activation_fn)
        self.initial = nn.Sequential(nn.Linear(d, H))
        self.regressor = PoseRegressor(H)

    def _compress(self, obs, knots):
        cfg = self.cfg
        return logsig_windows(obs, knots, depth=cfg.logsig_depth, window=cfg.logsig_window)

    def forward(self, fv: torch.Tensor, fi: torch.Tensor, ts: torch.Tensor,
                prev: Optional[Carry] = None,
                generator: Optional[torch.Generator] = None,
                cold: Optional[torch.Tensor] = None):
        """fv (B, S-1, v_f_len), fi (B, S-1, i_f_len), ts (B, S), prev the
        carry or None, ``cold`` (B,) the lanes that start afresh (with a
        carry, outside training). Returns (poses (B, S-1, 6), carry,
        SolveStats)."""
        cfg, train = self.cfg, self.training
        x = self.reduction_net(self.fuse(fv, fi, generator))
        ts = ts.float()
        mode = "train" if train else cfg.rde_streaming_mode
        if mode == "reset":
            prev = None
        if prev is None or train:
            cold = None
        history = mode == "history"
        ts_eff = ts if history or (prev is not None and not train) else ts - ts[:, :1]
        if cold is not None and not history:
            ts_eff = torch.where(cold[:, None], ts - ts[:, :1], ts_eff)
        knots = ts_eff[:, 1:]                                   # (B, S-1)
        obs = torch.cat([knots[..., None], x], dim=-1)          # (B, S-1, d)
        solve = cde_solver(self.cde_func, cfg.cde_hidden_dim, self.sig_dim, "linear",
                           self.solver, cfg.resolved_use_kernels(obs.device), train)
        if history:
            return self._history_step(obs, knots, prev, solve, cold)
        z0 = prev
        if prev is None or cold is not None:
            z_init = torch.tanh(self.initial(obs[:, 0]))
            z0 = z_init if prev is None else cold_lanes(cold, z_init, prev)
        ys, t_new = self._compress(obs, knots)
        zs, stats = solve(z0, t_new, ys, knots)
        return self.regressor(zs), zs[:, -1], solve_stats(stats)

    def _history_step(self, obs, knots, prev, solve, cold=None):
        K = self.cfg.rde_history_cap
        B, T, _ = obs.shape
        ys, t_new = self._compress(obs, knots)      # (B, W+1, D), (B, W+1)
        W, D = ys.shape[1] - 1, ys.shape[2]
        if K < W + 1:
            raise ValueError(f"rde_history_cap ({K}) must cover one window's "
                             f"{W + 1} compressed knots")

        def fresh():
            return {"z0": torch.tanh(self.initial(obs[:, 0])),
                    "y": torch.cat([ys.new_zeros(B, K - (W + 1), D), ys], dim=1),
                    "t": torch.cat([t_new.new_zeros(B, K - (W + 1)), t_new], dim=1),
                    "cnt": torch.full((B,), W + 1, dtype=torch.int32, device=obs.device)}

        if prev is None:
            z0, buf_y, buf_t, cnt = fresh().values()
        else:
            z0, buf_t, buf_y, cnt = prev["z0"], prev["t"], prev["y"], prev["cnt"]
            # advance z0 over the W outgoing segments (collapsed slots before
            # the buffer is full: a no-op)
            ev_t, ev_y = buf_t[:, :W + 1], buf_y[:, :W + 1]
            z0 = solve(z0, ev_t, ev_y, ev_t)[0][:, -1]
            # append, continuing the running sum from the buffer's last knot
            buf_y = torch.cat([buf_y[:, W:], buf_y[:, -1:] + ys[:, 1:]], dim=1)
            buf_t = torch.cat([buf_t[:, W:], t_new[:, 1:]], dim=1)
            cnt = torch.clamp_max(cnt + W, K)
            if cold is not None:
                z0, buf_y, buf_t, cnt = cold_lanes(cold, fresh(), {
                    "z0": z0, "y": buf_y, "t": buf_t, "cnt": cnt}).values()
        buf_t, buf_y = collapse_prefix(buf_t, cnt), collapse_prefix(buf_y, cnt)
        # evaluate at every buffered knot before the newest window, then at
        # the window's feature times: each sub-solve spans one path segment
        eval_ts = torch.cat([buf_t[:, 1:K - W], knots], dim=1)
        zs_all, stats = solve(z0, buf_t, buf_y, eval_ts)
        poses = self.regressor(zs_all[:, -T:])
        return poses, {"z0": z0, "t": buf_t, "y": buf_y, "cnt": cnt}, solve_stats(stats)
