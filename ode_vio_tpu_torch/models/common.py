"""Shared model components, train-mode dropout and the weight init of the
reference (kaiming-normal conv/linear with zero bias, BatchNorm scale 1 /
bias 0, stacked RNN/GRU at torch's default uniform; the LTC cell's
log_tau 0 and A ~ N(0, 0.1^2) as the JAX package draws them)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch
from torch import nn

from ode_vio_tpu_torch.ops.cuda_kernels import FusedDropout
from ode_vio_tpu_torch.ops.liquid import LTCCell
from ode_vio_tpu_torch.ops.mlp import apply_mlp, get_activation
from ode_vio_tpu_torch.ops.rnn_cells import init_cell

# A pose core's carry: one tensor, or a dict of tensors (cde/rde history mode)
Carry = Union[torch.Tensor, Dict[str, torch.Tensor]]


class SolveStats(NamedTuple):
    """Step counts of one forward: totals of accepted and rejected steps,
    and per lane (B,) the solves (ODE-RNN: per layer and interval; CDE:
    per segment) that ran out of ``max_steps`` before their end."""

    accepted: torch.Tensor
    rejected: torch.Tensor
    incomplete: torch.Tensor


def no_solve(batch: int, device) -> SolveStats:
    """The counts of a pose core that solves nothing (rnn, cfc, ltc)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return SolveStats(zero, zero, torch.zeros(batch, dtype=torch.int32, device=device))


_MASK64 = (1 << 64) - 1


def mix_key(key: int, index: int) -> int:
    """``key`` for data-parallel rank coordinate ``index``: itself at 0,
    else splitmix64's finalizer of ``key`` xor the golden-ratio multiple
    of ``index``."""
    if index == 0:
        return key
    z = (key ^ (index * 0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class RankKeys(NamedTuple):
    """The train state's generator as the data-parallel rank at data
    coordinate ``index`` draws from it. The generator is the same on every rank and
    advances the same: each draw is one key (:func:`draw_key`), mixed with
    the rank's coordinate (:func:`mix_key`), so ranks drop and sample
    differently, and a device draw (:func:`on_device`) always goes through
    such a key."""

    generator: torch.Generator
    index: int


class LaneDraws(NamedTuple):
    """``generator`` as a replica serving lanes ``start..start+B`` of
    ``total`` draws from it: hard fusion draws its noise for all ``total``
    lanes and keeps its own, so replicas that split the lanes draw what
    one forward over all of them draws."""

    generator: torch.Generator
    start: int
    total: int


def draw_key(generator) -> int:
    """A 64-bit key drawn from ``generator`` (a CPU generator draws it
    without waiting for the device); a :class:`RankKeys` mixes in its
    rank."""
    if isinstance(generator, RankKeys):
        return mix_key(draw_key(generator.generator), generator.index)
    lo, hi = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=generator,
                           device=generator.device).tolist()
    return lo | hi << 32


def on_device(generator, device: torch.device):
    """``generator`` where it lies on ``device``, else a generator on
    ``device`` seeded with a key drawn from it; a :class:`RankKeys` always
    seeds one, a :class:`LaneDraws` is kept."""
    if isinstance(generator, LaneDraws):
        return generator
    if isinstance(generator, RankKeys) or generator.device != device:
        return torch.Generator(device).manual_seed(draw_key(generator))
    return generator


def train_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], *,
                  fast: bool = False, use_kernels: bool = False) -> torch.Tensor:
    """Train-mode dropout at ``rate``, its randomness from ``generator``.
    ``fast``: the keyed Philox mask of kernel K3 (its plain version unless
    ``use_kernels``), one key per call; else a Bernoulli mask drawn on
    ``x``'s device, as flax's ``nn.Dropout``. Rate 0 returns ``x``."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout draws a mask: pass a torch.Generator")
    if fast:
        return FusedDropout.apply(x, draw_key(generator), rate, use_kernels)
    keep = torch.rand(x.shape, generator=on_device(generator, x.device),
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Activation(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_activation(name)

    def forward(self, x):
        return self.fn(x)


class MLPField(nn.Module):
    """A tanh-bounded MLP vector field (the ODE-RNN's f(t, h) = MLP(h), the
    CDE cores' g(z) before its reshape); linear layers at the reference
    indices ``net.0``, ``net.2``, ..."""

    def __init__(self, sizes, activation: str):
        super().__init__()
        self.activation = activation
        mods = []
        for i in range(len(sizes) - 1):
            mods.append(nn.Linear(sizes[i], sizes[i + 1]))
            mods.append(Activation(activation) if i < len(sizes) - 2 else nn.Tanh())
        self.net = nn.Sequential(*mods)

    def layers(self):
        return [(m.weight, m.bias) for m in self.net if isinstance(m, nn.Linear)]

    def forward(self, t, y):
        return apply_mlp(self.layers(), y, self.activation)


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
        elif isinstance(m, LTCCell):
            m.init_extra(generator)  # its Linears are drawn as every Linear
        elif isinstance(m, (nn.RNN, nn.GRU)):
            for l in range(m.num_layers):
                cell = init_cell("gru" if isinstance(m, nn.GRU) else "rnn",
                                 m.input_size if l == 0 else m.hidden_size,
                                 m.hidden_size, generator)
                for k, v in cell.items():
                    kind, part = k.split("_")
                    getattr(m, f"{'weight' if kind == 'w' else 'bias'}_{part}_l{l}").copy_(v)
