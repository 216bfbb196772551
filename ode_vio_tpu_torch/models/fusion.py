"""Visual-inertial fusion gates (counterpart of
``ode_vio_tpu/models/fusion.py``): ``cat`` concatenates, ``soft`` scales
the concatenation by learned elementwise weights, ``hard`` masks it
per feature with a straight-through Gumbel-softmax sample (tau=1), its
noise from the generator the forward is given (or one seeded from it on
the features' device)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.models.common import LaneDraws, on_device


def gumbel_softmax(logits: torch.Tensor, generator) -> torch.Tensor:
    """Straight-through Gumbel-softmax (tau=1, hard) over the last axis,
    its noise drawn from ``generator`` (on ``logits``' device; a
    ``LaneDraws`` draws for all its lanes and keeps these, the leading
    axis)."""
    if isinstance(generator, LaneDraws):
        n = logits.shape[0]
        u = torch.rand((generator.total, *logits.shape[1:]), generator=generator.generator,
                       device=logits.device, dtype=logits.dtype)[generator.start:
                                                                 generator.start + n]
    else:
        u = torch.rand(logits.shape, generator=generator, device=logits.device,
                       dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    y_soft = torch.softmax(logits + g, dim=-1)
    index = y_soft.argmax(dim=-1, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(-1, index, 1.0)
    return y_hard + y_soft - y_soft.detach()


class FusionModule(nn.Module):
    def __init__(self, feature_dim: int, fuse_method: str = "cat"):
        super().__init__()
        if fuse_method not in ("cat", "soft", "hard"):
            raise ValueError(f"fuse method '{fuse_method}' not supported")
        self.fuse_method = fuse_method
        if fuse_method == "soft":
            self.net = nn.Sequential(nn.Linear(feature_dim, feature_dim))
        elif fuse_method == "hard":
            self.net = nn.Sequential(nn.Linear(feature_dim, 2 * feature_dim))

    def forward(self, v: torch.Tensor, i: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = torch.cat([v, i], dim=-1)
        if self.fuse_method == "cat":
            return feat
        if self.fuse_method == "soft":
            return feat * self.net(feat)
        if generator is None:
            raise ValueError("hard fusion samples a mask: pass a torch.Generator")
        logits = self.net(feat).reshape(feat.shape + (2,))
        return feat * gumbel_softmax(logits, on_device(generator, feat.device))[..., 0]
