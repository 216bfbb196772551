"""The weights of a run, made on the device from ``--seed``.

Every tensor of the model's state dict (:func:`reference.model.param_specs`:
Kaiming-normal convolutions and linear layers with zero biases, uniform
RNN weights, BatchNorm at scale 1 and shift 0 with unit running variance)
is cut from two large draws of one ``torch.Generator`` on the device, one
normal and one uniform, in float32. Both sides of the comparison get the
same dict: the measured program loads it, and the reference reads it.
"""

from __future__ import annotations

from typing import Dict

import torch

from vio_bench.reference.model import param_specs


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = param_specs(model)
    gen = torch.Generator(device).manual_seed(seed)
    n_normal = sum(_numel(s) for _, s, (kind, _) in specs if kind == "normal")
    n_uniform = sum(_numel(s) for _, s, (kind, _) in specs if kind == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    out, used = {}, {"normal": 0, "uniform": 0}
    for name, shape, (kind, value) in specs:
        n = _numel(shape)
        if kind in used:
            pool = normal if kind == "normal" else uniform
            out[name] = (pool[used[kind]:used[kind] + n] * value).reshape(shape)
            used[kind] += n
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[name] = torch.full(shape, value, device=device)
    return out


def check_layout(weights: Dict[str, torch.Tensor], state_dict: Dict[str, torch.Tensor]) -> None:
    """Raise unless ``weights`` has exactly the names, shapes and dtypes of
    the program's ``state_dict``."""
    ours = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
    theirs = {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()}
    if ours != theirs:
        diff = sorted(set(ours.items()) ^ set(theirs.items()))
        raise ValueError(f"the benchmark's weights do not fit the program's model: {diff[:8]}")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
