"""PoseCDE, the neural-CDE pose core (counterpart of
``ode_vio_tpu/models/pose_cde.py``).

The fused features, reduced to ``cde_hidden_dim`` channels and augmented
with their times, are the knots of a control path X(t) (linear or
cubic-Hermite); ``dz = g(z) dX(t)`` is integrated through the window's
feature times, and the states regress to per-step poses. Streaming modes
(``cde_streaming_mode``):

* ``carry``: the carry is the last evaluated z (B, H) and the next window
  continues from it on the sequence clock;
* ``history``: the carry is a ring buffer of the last ``cde_history_cap``
  observations with the first window's z0; every window re-integrates the
  whole buffer, first advancing z0 over the slots it evicts. Slots not yet
  filled collapse onto the earliest valid observation, so their segments
  have zero length;
* ``reset``: every window starts fresh.

In eval mode the solve runs kernel K2 (``ops/cuda_kernels.py::
fused_cde_solve``) when ``use_kernels`` resolves on (auto: CUDA tensors),
else the solver core (``ops/interpolation.py::cdeint_batched``). In train
mode (``self.training``) every window runs the training regime, whatever
the streaming mode: the window clock ``ts - ts[:, :1]``, z0 from its first
observation (or the carry given), and the solver core's bounded,
differentiable solve (budget ``max_steps_train``). K2 has no backward, so
a training forward never reaches it, on CUDA tensors too (JAX gates its
fused kernel with ``not train`` alike). Every carry leaf has its lane on
axis 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import ModelConfig, SolverConfig
from ode_vio_tpu_torch.models.common import Carry, MLPField, PoseRegressor, SolveStats
from ode_vio_tpu_torch.models.fusion import FusionModule
from ode_vio_tpu_torch.ops.interpolation import cdeint_batched, cdeint_fused
from ode_vio_tpu_torch.ops.mlp import apply_cde_func, cde_func_sizes
from ode_vio_tpu_torch.ops.solvers.odeint import SolverOptions


def cde_solver(field: MLPField, hidden: int, channels: int, kind: str,
               solver: SolverConfig, use_kernels: bool, train: bool):
    """``solve(z0, ts, xs, eval_ts) -> (zs, Stats)`` for the field ``g(z) =
    field(z).reshape(hidden, channels)`` on the paths ``make_path(ts, xs,
    kind)``: with ``train`` the solver core's bounded solve, else kernel K2
    (``use_kernels``) or the solver core's inference solve."""
    layers = field.layers()
    opts = SolverOptions.from_config(solver, train=train)
    if use_kernels and not train:
        return lambda z0, ts, xs, ev: cdeint_fused(
            layers, field.activation, z0, ts, xs, ev, kind, opts)
    g = lambda z: apply_cde_func(layers, z, field.activation, hidden, channels)  # noqa: E731
    return lambda z0, ts, xs, ev: cdeint_batched(g, z0, ts, xs, ev, kind, opts, train)


def solve_stats(stats) -> SolveStats:
    """Per-row solver counts -> totals and the per-lane incomplete count."""
    return SolveStats(stats.accepted.sum(), stats.rejected.sum(), stats.incomplete)


def collapse_prefix(buf: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Slots before the last ``cnt`` of ``buf`` (B, K, ...) take the value
    of the earliest valid slot."""
    B, K = buf.shape[:2]
    first = (K - cnt).long()
    idx = first.reshape((B, 1) + (1,) * (buf.dim() - 2)).expand((B, 1) + buf.shape[2:])
    valid = torch.arange(K, device=buf.device)[None, :] >= first[:, None]
    return torch.where(valid.reshape(valid.shape + (1,) * (buf.dim() - 2)), buf,
                       buf.gather(1, idx))


class PoseCDE(nn.Module):
    carry_lane_axis = 0  # z (B, H), or the history dict of (B, ...) leaves

    def __init__(self, cfg: ModelConfig, solver: SolverConfig):
        super().__init__()
        self.cfg = cfg
        self.solver = solver
        F, H = cfg.f_len, cfg.cde_hidden_dim
        self.input_dim = H + 1  # reduced features + time
        self.fuse = FusionModule(F, cfg.fuse_method)
        self.reduction_net = nn.Sequential(nn.Linear(F, F // 2), nn.LeakyReLU(0.1),
                                           nn.Linear(F // 2, H))
        self.cde_func = MLPField(cde_func_sizes(self.input_dim, H, cfg.cde_fn_num_layers),
                                 cfg.cde_activation_fn)
        self.initial = nn.Sequential(nn.Linear(self.input_dim, H))
        self.regressor = PoseRegressor(H)

    def forward(self, fv: torch.Tensor, fi: torch.Tensor, ts: torch.Tensor,
                prev: Optional[Carry] = None,
                generator: Optional[torch.Generator] = None):
        """fv (B, S-1, v_f_len), fi (B, S-1, i_f_len), ts (B, S), prev the
        carry or None. Returns (poses (B, S-1, 6), carry, SolveStats)."""
        cfg, train = self.cfg, self.training
        x = self.reduction_net(self.fuse(fv, fi, generator))
        ts = ts.float()
        mode = "train" if train else cfg.cde_streaming_mode
        if mode == "reset":
            prev = None
        history = mode == "history"
        # history mode keeps one clock for the whole buffer; training and
        # a cold start run on the window's own clock
        ts_eff = ts if history or (prev is not None and not train) else ts - ts[:, :1]
        knots = ts_eff[:, 1:]                                   # (B, S-1)
        obs = torch.cat([knots[..., None], x], dim=-1)          # (B, S-1, H+1)
        solve = cde_solver(self.cde_func, cfg.cde_hidden_dim, self.input_dim,
                           cfg.cde_interpolation, self.solver,
                           cfg.resolved_use_kernels(obs.device), train)
        if history:
            return self._history_step(obs, prev, solve)
        z0 = torch.tanh(self.initial(obs[:, 0])) if prev is None else prev
        zs, stats = solve(z0, knots, obs, knots)                # (B, S-1, H)
        return self.regressor(zs), zs[:, -1], solve_stats(stats)

    def _history_step(self, obs, prev, solve):
        K = self.cfg.cde_history_cap
        B, T, D = obs.shape
        if K < T:
            raise ValueError(f"cde_history_cap ({K}) must cover one window ({T} obs)")
        if prev is None:
            z0 = torch.tanh(self.initial(obs[:, 0]))
            buf = torch.cat([obs.new_zeros(B, K - T, D), obs], dim=1)
            cnt = torch.full((B,), T, dtype=torch.int32, device=obs.device)
        else:
            z0, buf, cnt = prev["z0"], prev["buf"], prev["cnt"]
            # advance z0 over the T outgoing slots (before the buffer is
            # full they are collapsed: zero-length segments, a no-op)
            evict = buf[:, :T + 1]
            z0 = solve(z0, evict[:, :, 0], evict, evict[:, :, 0])[0][:, -1]
            buf = torch.cat([buf[:, T:], obs], dim=1)
            cnt = torch.clamp_max(cnt + T, K)
        buf = collapse_prefix(buf, cnt)
        zs_all, stats = solve(z0, buf[:, :, 0], buf, buf[:, :, 0])
        poses = self.regressor(zs_all[:, -T:])
        return poses, {"z0": z0, "buf": buf, "cnt": cnt}, solve_stats(stats)
