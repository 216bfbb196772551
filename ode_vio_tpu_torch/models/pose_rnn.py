"""PoseRNN, the discrete recurrent pose core (counterpart of
``ode_vio_tpu/models/pose_rnn.py``): the fusion, RNN/GRU stack and
regressor of PoseODERNN with no continuous-time evolution between frames;
the timestamps are unused. In train mode ``rnn_dropout_out`` drops the
stack's outputs with a mask from the forward's generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import ModelConfig
from ode_vio_tpu_torch.models.common import PoseRegressor, no_solve, train_dropout
from ode_vio_tpu_torch.models.fusion import FusionModule
from ode_vio_tpu_torch.ops.rnn_cells import stack_layers, step_stack


class PoseRNN(nn.Module):
    carry_lane_axis = 1  # carry (L, B, F)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.ode_rnn_type not in ("rnn", "gru"):
            raise ValueError(f"ode_rnn_type '{cfg.ode_rnn_type}' not supported; "
                             "choose rnn or gru")
        self.cfg = cfg
        F = cfg.f_len
        self.fuse = FusionModule(F, cfg.fuse_method)
        rnn = nn.GRU if cfg.ode_rnn_type == "gru" else nn.RNN
        self.rnn = rnn(F, F, cfg.rnn_num_layers)
        self.regressor = PoseRegressor(F)

    def forward(self, fv: torch.Tensor, fi: torch.Tensor, ts: torch.Tensor,
                prev: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """fv (B, S-1, v_f_len), fi (B, S-1, i_f_len), ts unused, prev
        (L, B, F) or None. Returns (poses (B, S-1, 6), hidden (L, B, F),
        SolveStats with no solves)."""
        cfg = self.cfg
        fused = self.fuse(fv, fi, generator)
        B, steps, F = fused.shape
        h = fused.new_zeros(cfg.rnn_num_layers, B, F) if prev is None else prev
        cells = stack_layers(self.rnn)
        outs = []
        for k in range(steps):
            out, h = step_stack(cfg.ode_rnn_type, cells, fused[:, k], h)
            outs.append(out)
        outs = torch.stack(outs, dim=1)
        if self.training:
            outs = train_dropout(outs, cfg.rnn_dropout_out, generator)
        return self.regressor(outs), h, no_solve(B, fused.device)
