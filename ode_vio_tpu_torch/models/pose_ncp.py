"""PoseNCP, the liquid-network pose core with a CfC or an LTC cell
(counterpart of ``ode_vio_tpu/models/pose_ncp.py``).

The per-step elapsed times ``ts[:, 1:] - ts[:, :-1]`` drive the cell of
each lane, and the poses regress on each step's hidden-state delta. The
cell lives at ``rnn.rnn_cell`` (CfC) or ``rnn`` (LTC), as the reference
layout names it; the carry is ``(B, rnn_hidden_dim)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import ModelConfig
from ode_vio_tpu_torch.models.common import PoseRegressor, no_solve
from ode_vio_tpu_torch.models.fusion import FusionModule
from ode_vio_tpu_torch.ops.liquid import CfCCell, LTCCell


class PoseNCP(nn.Module):
    carry_lane_axis = 0  # carry (B, H)

    def __init__(self, cfg: ModelConfig, cell_type: str = "cfc"):
        super().__init__()
        self.cfg = cfg
        F, H = cfg.f_len, cfg.rnn_hidden_dim
        self.fuse = FusionModule(F, cfg.fuse_method)
        if cell_type == "cfc":
            self.rnn = nn.Module()
            self.rnn.rnn_cell = CfCCell(F, H)
        elif cell_type == "ltc":
            self.rnn = LTCCell(F, H)
        else:
            raise ValueError(f"NCP cell '{cell_type}' not supported")
        self.regressor = PoseRegressor(H)

    @property
    def cell(self) -> nn.Module:
        return getattr(self.rnn, "rnn_cell", self.rnn)

    def forward(self, fv: torch.Tensor, fi: torch.Tensor, ts: torch.Tensor,
                prev: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """fv (B, S-1, v_f_len), fi (B, S-1, i_f_len), ts (B, S), prev
        (B, H) or None. Returns (poses (B, S-1, 6), hidden (B, H),
        SolveStats with no solves)."""
        fused = self.fuse(fv, fi, generator)
        B, steps, _ = fused.shape
        h = fused.new_zeros(B, self.cfg.rnn_hidden_dim) if prev is None else prev
        ts = ts.float()
        elapsed = ts[:, 1:] - ts[:, :-1]                      # (B, S-1)
        deltas = []
        for k in range(steps):
            h_new = self.cell(fused[:, k], h, elapsed[:, k])
            deltas.append(h_new - h)
            h = h_new
        return self.regressor(torch.stack(deltas, dim=1)), h, no_solve(B, fused.device)
