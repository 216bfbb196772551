"""Recurrent cells as plain functions on tensors (counterpart of
``ode_vio_tpu/ops/rnn_cells.py``).

Layout and gate order follow ``nn.RNN``/``nn.GRU``/``nn.LSTM``: weights
``(G*H, in)``, GRU gates (r, z, n), LSTM gates (i, f, g, o). A layer is
the dict ``{'w_ih', 'w_hh', 'b_ih', 'b_hh'}``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

GATES = {"rnn": 1, "gru": 3, "lstm": 4}

Cell = Dict[str, torch.Tensor]


def init_cell(cell_type: str, input_size: int, hidden_size: int,
              generator: torch.Generator) -> Cell:
    """torch's default init: U(-1/sqrt(H), 1/sqrt(H)) for every tensor."""
    g = GATES[cell_type]
    bound = 1.0 / math.sqrt(hidden_size)
    shapes = {"w_ih": (g * hidden_size, input_size),
              "w_hh": (g * hidden_size, hidden_size),
              "b_ih": (g * hidden_size,), "b_hh": (g * hidden_size,)}
    return {k: (torch.rand(s, generator=generator) * 2 - 1) * bound
            for k, s in shapes.items()}


def stack_layers(rnn) -> List[Cell]:
    """The layers of an ``nn.RNN``/``nn.GRU`` as cells, its own tensors."""
    return [{"w_ih": getattr(rnn, f"weight_ih_l{l}"), "w_hh": getattr(rnn, f"weight_hh_l{l}"),
             "b_ih": getattr(rnn, f"bias_ih_l{l}"), "b_hh": getattr(rnn, f"bias_hh_l{l}")}
            for l in range(rnn.num_layers)]


def rnn_tanh_cell(p: Cell, x, h):
    return torch.tanh(x @ p["w_ih"].T + p["b_ih"] + h @ p["w_hh"].T + p["b_hh"])


def gru_cell(p: Cell, x, h):
    gi = x @ p["w_ih"].T + p["b_ih"]
    gh = h @ p["w_hh"].T + p["b_hh"]
    gi_r, gi_z, gi_n = gi.chunk(3, dim=-1)
    gh_r, gh_z, gh_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(gi_r + gh_r)
    z = torch.sigmoid(gi_z + gh_z)
    n = torch.tanh(gi_n + r * gh_n)
    return (1.0 - z) * n + z * h


def lstm_cell(p: Cell, x, hc):
    h, c = hc
    gates = x @ p["w_ih"].T + p["b_ih"] + h @ p["w_hh"].T + p["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def step_stack(cell_type: str, layers: Sequence[Cell], x, h):
    """Advance a multi-layer stack one timestep.

    x: (B, in). h: (L, B, H) (LSTM: a pair of (L, B, H)).
    Returns (top-layer output (B, H), new hidden (L, B, H)).
    """
    if cell_type == "lstm":
        new_h: List[torch.Tensor] = []
        new_c: List[torch.Tensor] = []
        inp = x
        for l, p in enumerate(layers):
            hl, cl = lstm_cell(p, inp, (h[0][l], h[1][l]))
            new_h.append(hl)
            new_c.append(cl)
            inp = hl
        return inp, (torch.stack(new_h), torch.stack(new_c))
    cells = {"rnn": rnn_tanh_cell, "gru": gru_cell}
    if cell_type not in cells:
        raise ValueError(f"cell type '{cell_type}' not supported")
    cell = cells[cell_type]
    new_h = []
    inp = x
    for l, p in enumerate(layers):
        inp = cell(p, inp, h[l])
        new_h.append(inp)
    return inp, torch.stack(new_h)
