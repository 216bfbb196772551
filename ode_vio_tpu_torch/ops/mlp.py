"""MLP vector fields of the continuous-time cores, as plain functions on
tensors (counterpart of ``ode_vio_tpu/ops/mlp.py``).

Layers are ``(w, b)`` pairs in the torch ``(out, in)`` layout, the layout
of the reference checkpoints and of ``nn.Linear``.

Softplus is written as ``max(x, 0) + log1p(exp(-|x|))``, which is what
``jax.nn.softplus`` (``logaddexp(x, 0)``) computes for every x.
``torch.nn.functional.softplus`` returns ``x`` itself above its
``threshold=20`` and so differs from it; the fused kernel
(``csrc/fused_ode_solve.cu``) uses the same formula as this module.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

Layer = Tuple[torch.Tensor, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leaky_relu": lambda x: torch.nn.functional.leaky_relu(x, 0.01),
    "softplus": softplus,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Activation '{name}' not supported; choose from {sorted(ACTIVATIONS)}"
        ) from None


def init_mlp(sizes: Sequence[int], generator: torch.Generator) -> List[Layer]:
    """Kaiming-normal weights (gain sqrt(2), fan_in) and zero biases, the
    reference's init of every Linear."""
    return [(math.sqrt(2.0 / sizes[i]) * torch.randn(sizes[i + 1], sizes[i], generator=generator),
             torch.zeros(sizes[i + 1]))
            for i in range(len(sizes) - 1)]


def apply_mlp(layers: Sequence[Layer], x: torch.Tensor, activation: str,
              final_tanh: bool = True) -> torch.Tensor:
    """Linear -> act -> ... -> Linear [-> tanh]."""
    act = get_activation(activation)
    for w, b in layers[:-1]:
        x = act(x @ w.T + b)
    w, b = layers[-1]
    x = x @ w.T + b
    return torch.tanh(x) if final_tanh else x


def ode_func_sizes(feature_dim: int, hidden_dim: int, num_hidden_layers: int):
    """feature -> hidden x num_hidden_layers -> feature."""
    return [feature_dim] + [hidden_dim] * num_hidden_layers + [feature_dim]


def cde_func_sizes(input_dim: int, hidden_dim: int, num_hidden_layers: int):
    """hidden -> hidden x num_hidden_layers -> hidden*input_dim, reshaped to
    the (hidden, input_dim) CDE field matrix."""
    return [hidden_dim] + [hidden_dim] * num_hidden_layers + [hidden_dim * input_dim]


def apply_cde_func(layers: Sequence[Layer], z: torch.Tensor, activation: str,
                   hidden_dim: int, input_dim: int) -> torch.Tensor:
    """The CDE field g(z): (..., hidden) -> (..., hidden, input_dim), the
    last layer's outputs h-major (output h*input_dim + c is entry (h, c))."""
    out = apply_mlp(layers, z, activation)
    return out.reshape(out.shape[:-1] + (hidden_dim, input_dim))
