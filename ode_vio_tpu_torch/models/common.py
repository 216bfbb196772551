"""Shared model components and the weight init of the reference
(kaiming-normal conv/linear with zero bias, BatchNorm scale 1 / bias 0,
stacked RNN/GRU at torch's default uniform)."""

from __future__ import annotations

import torch
from torch import nn

from ode_vio_tpu_torch.ops.rnn_cells import init_cell


class PoseRegressor(nn.Sequential):
    """hidden -> 128 -> LeakyReLU(0.1) -> 6-DoF relative pose."""

    def __init__(self, in_dim: int):
        super().__init__(nn.Linear(in_dim, 128), nn.LeakyReLU(0.1),
                         nn.Linear(128, 6))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of ``model`` in place from ``generator``
    (a CPU generator; tensors on other devices are drawn on the CPU and
    copied)."""
    def draw(t: torch.Tensor, fill) -> None:
        t.copy_(fill(torch.empty(t.shape, dtype=t.dtype)))

    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            draw(m.weight, lambda x: nn.init.kaiming_normal_(
                x, nonlinearity="relu", generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, (nn.RNN, nn.GRU)):
            for l in range(m.num_layers):
                cell = init_cell("gru" if isinstance(m, nn.GRU) else "rnn",
                                 m.input_size if l == 0 else m.hidden_size,
                                 m.hidden_size, generator)
                for k, v in cell.items():
                    kind, part = k.split("_")
                    getattr(m, f"{'weight' if kind == 'w' else 'bias'}_{part}_l{l}").copy_(v)
