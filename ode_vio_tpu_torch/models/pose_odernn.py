"""PoseODERNN, the flagship ODE-RNN pose core (counterpart of
``ode_vio_tpu/models/pose_odernn.py``).

Per frame interval, the hidden states of all L layers and B lanes fold
into one (L*B, F) adaptive solve of dh/dt = MLP(h); the RNN stack then
takes the fused features. The controller's final step size warm-starts
the next interval's solve, per row; each window starts from ``dt0``.
Timestamps are re-based to 0 only when no carried state is given.

In eval mode the adaptive solve runs the fused CUDA kernel K1
(``ops/cuda_kernels.py``) when ``use_kernels`` resolves on (auto: CUDA
tensors), else the solver core (``ops/solvers/odeint.py``). In train mode
it is always the solver core, as JAX takes its fused kernel only outside
training: the bounded, differentiable solve (``solve_ivp_batched_dt``,
budget ``max_steps_train``), or with ``unroll_mode='adjoint'`` the
continuous adjoint (``solve_ivp_adjoint``), where every interval starts
from ``dt0`` and the counts are zero, as in JAX. Fixed-step and Adams
solves (``adaptive=False``, the Adams method strings) always run the
solver core, never K1. ``rnn_dropout_out`` drops RNN outputs in train
mode with a mask from the forward's generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import ModelConfig, SolverConfig
from ode_vio_tpu_torch.models.common import MLPField, PoseRegressor, SolveStats, train_dropout
from ode_vio_tpu_torch.models.fusion import FusionModule
from ode_vio_tpu_torch.ops.cuda_kernels import fused_ode_solve
from ode_vio_tpu_torch.ops.mlp import apply_mlp, ode_func_sizes
from ode_vio_tpu_torch.ops.rnn_cells import stack_layers, step_stack
from ode_vio_tpu_torch.ops.solvers.odeint import (SolverOptions, solve_ivp_adjoint,
                                                  solve_ivp_batched_dt, solve_ivp_dt)


class PoseODERNN(nn.Module):
    carry_lane_axis = 1  # carry (L, B, F)

    def __init__(self, cfg: ModelConfig, solver: SolverConfig):
        super().__init__()
        if cfg.ode_rnn_type not in ("rnn", "gru"):
            raise ValueError(f"ode_rnn_type '{cfg.ode_rnn_type}' not supported; "
                             "choose rnn or gru")
        self.cfg = cfg
        self.solver = solver
        F = cfg.f_len
        self.fuse = FusionModule(F, cfg.fuse_method)
        self.ode_func = MLPField(
            ode_func_sizes(F, cfg.ode_hidden_dim, cfg.ode_fn_num_layers),
            cfg.ode_activation_fn)
        rnn = nn.GRU if cfg.ode_rnn_type == "gru" else nn.RNN
        self.rnn = rnn(F, F, cfg.rnn_num_layers)
        self.regressor = PoseRegressor(F)

    def forward(self, fv: torch.Tensor, fi: torch.Tensor, ts: torch.Tensor,
                prev: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """fv (B, S-1, v_f_len), fi (B, S-1, i_f_len), ts (B, S), prev
        (L, B, F) carried hidden or None. Returns (poses (B, S-1, 6),
        hidden (L, B, F), SolveStats)."""
        cfg, train = self.cfg, self.training
        opts = SolverOptions.from_config(self.solver, train=train)
        adjoint = opts.unroll_mode == "adjoint"  # training options only
        F, L = cfg.f_len, cfg.rnn_num_layers
        B, steps, _ = fv.shape
        fused = self.fuse(fv, fi, generator)
        h = fused.new_zeros(L, B, F) if prev is None else prev
        ts = ts.float()
        ts_eff = ts - ts[:, :1] if prev is None else ts

        layers = self.ode_func.layers()
        params = tuple(p for layer in layers for p in layer)
        use_kernels = (cfg.resolved_use_kernels(fused.device) and not train
                       and opts.adaptive)
        cells = stack_layers(self.rnn)
        dt = torch.full((L * B,), opts.dt0, dtype=torch.float32, device=fused.device)
        accepted = torch.zeros((), dtype=torch.int64, device=fused.device)
        rejected = torch.zeros_like(accepted)
        incomplete = torch.zeros(B, dtype=torch.int32, device=fused.device)
        outs = []
        for k in range(steps):
            t0, t1 = ts_eff[:, k].repeat(L), ts_eff[:, k + 1].repeat(L)
            y = h.reshape(L * B, F).contiguous()
            if adjoint:
                # every interval from dt0 (dt passes through), no counts
                y1 = solve_ivp_adjoint(self._adjoint_field, opts, y, t0, t1, params)
            else:
                if use_kernels:
                    y1, dt, acc, rej, inc = fused_ode_solve(
                        layers, y, t0, t1, activation=cfg.ode_activation_fn,
                        method=opts.method, rtol=opts.rtol, atol=opts.atol,
                        dt0=dt, max_steps=opts.max_steps, safety=opts.safety,
                        factor_min=opts.factor_min, factor_max=opts.factor_max)
                else:
                    solve = solve_ivp_batched_dt if train else solve_ivp_dt
                    y1, dt, (acc, rej, inc) = solve(self.ode_func, y, t0, t1, opts, dt)
                accepted += acc.sum()
                rejected += rej.sum()
                incomplete += inc.reshape(L, B).sum(0, dtype=torch.int32)
            out, h = step_stack(cfg.ode_rnn_type, cells, fused[:, k],
                                y1.reshape(L, B, F))
            outs.append(out)
        outs = torch.stack(outs, dim=1)
        if train:
            outs = train_dropout(outs, cfg.rnn_dropout_out, generator)
        pose = self.regressor(outs)
        return pose, h, SolveStats(accepted, rejected, incomplete)

    def _adjoint_field(self, t, y, params, lane):
        """The field MLP(y) on its weights as explicit arguments."""
        return apply_mlp(list(zip(params[::2], params[1::2])), y, self.cfg.ode_activation_fn)
