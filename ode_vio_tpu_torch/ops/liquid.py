"""Liquid time-constant cells, CfC and LTC (counterpart of
``ode_vio_tpu/ops/liquid.py``).

* CfC, the closed-form continuous-depth cell ('default' mode): a tanh
  backbone over ``[x, h]``, two candidate states ``ff1`` / ``ff2`` blended
  by the sigmoid time gate ``sigmoid(time_a(z) * elapsed + time_b(z))``,
  so the elapsed time of each lane enters directly, with no solve.
* LTC: ``dh/dt = -(1/tau + f) h + f A`` with conductance
  ``f = sigmoid(w_x(x) + w_h(h))``, integrated over the elapsed time by
  ``unfolds`` semi-implicit Euler steps
  ``h <- (h + dt f A) / (1 + dt (1/tau + f))``, ``1/tau = exp(-log_tau)``.

The cells are plain functions over tensors (:func:`cfc_cell`,
:func:`ltc_cell`); :class:`CfCCell` and :class:`LTCCell` hold their
parameters under the reference layout's names (``backbone.0``, ``ff1``,
``ff2``, ``time_a``, ``time_b``; ``w_x``, ``w_h``, ``log_tau``, ``A``).
``elapsed`` is a scalar or one value per lane, ``(B,)``.
"""

from __future__ import annotations

import torch
from torch import nn


def _per_lane(elapsed, like: torch.Tensor) -> torch.Tensor:
    elapsed = torch.as_tensor(elapsed, dtype=like.dtype, device=like.device)
    return elapsed[:, None] if elapsed.dim() == 1 else elapsed


def cfc_cell(cell: "CfCCell", x: torch.Tensor, h: torch.Tensor, elapsed) -> torch.Tensor:
    """One CfC update. x (B, in), h (B, H), elapsed (B,) or a scalar."""
    z = torch.tanh(cell.backbone(torch.cat([x, h], dim=-1)))
    ff1 = torch.tanh(cell.ff1(z))
    ff2 = torch.tanh(cell.ff2(z))
    gate = torch.sigmoid(cell.time_a(z) * _per_lane(elapsed, z) + cell.time_b(z))
    return ff1 * (1.0 - gate) + ff2 * gate


def ltc_cell(cell: "LTCCell", x: torch.Tensor, h: torch.Tensor, elapsed,
             unfolds: int = 6) -> torch.Tensor:
    """``unfolds`` semi-implicit Euler steps of the LTC dynamics over
    ``elapsed``. x (B, in), h (B, H), elapsed (B,) or a scalar."""
    dt = _per_lane(elapsed, h) / unfolds
    inv_tau = torch.exp(-cell.log_tau)
    gx = cell.w_x(x)  # the input's drive, constant over the step
    for _ in range(unfolds):
        f = torch.sigmoid(gx + cell.w_h(h))
        h = (h + dt * f * cell.A) / (1.0 + dt * (inv_tau + f))
    return h


class CfCCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, backbone_units: int = 128):
        super().__init__()
        self.backbone = nn.Sequential(nn.Linear(input_size + hidden_size, backbone_units))
        self.ff1 = nn.Linear(backbone_units, hidden_size)
        self.ff2 = nn.Linear(backbone_units, hidden_size)
        self.time_a = nn.Linear(backbone_units, hidden_size)
        self.time_b = nn.Linear(backbone_units, hidden_size)

    def forward(self, x, h, elapsed):
        return cfc_cell(self, x, h, elapsed)


class LTCCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.w_x = nn.Linear(input_size, hidden_size)
        self.w_h = nn.Linear(hidden_size, hidden_size)
        self.log_tau = nn.Parameter(torch.zeros(hidden_size))
        self.A = nn.Parameter(torch.zeros(hidden_size))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        """The JAX init of the vectors: log_tau 0, A ~ N(0, 0.1^2) (the
        Linears take the model's kaiming init)."""
        self.log_tau.zero_()
        self.A.copy_(0.1 * torch.randn(self.A.shape, generator=generator))

    def forward(self, x, h, elapsed):
        return ltc_cell(self, x, h, elapsed)
