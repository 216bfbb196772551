"""Depth-2 log-signatures of piecewise-linear paths (counterpart of
``ode_vio_tpu/ops/logsig.py``).

The depth-2 log-signature of a path ``X: [0,T] -> R^C`` is the total
increment ``S1 = X(T) - X(0)`` (C terms) and the Levy area, the
antisymmetric part of the second signature level (C*(C-1)/2 terms). For
a piecewise-linear path both are closed-form sums over the segment
increments.
"""

from __future__ import annotations

import torch


def logsig_dim(channels: int, depth: int = 2) -> int:
    """Dimension of the depth-1/2 log-signature of a C-channel path."""
    if depth == 1:
        return channels
    if depth == 2:
        return channels + (channels * (channels - 1)) // 2
    raise ValueError("only depth 1 and 2 are supported")


def logsignature(xs: torch.Tensor, depth: int = 2) -> torch.Tensor:
    """xs (..., T, C) observations -> (..., logsig_dim)."""
    increments = xs[..., 1:, :] - xs[..., :-1, :]          # (..., T-1, C)
    s1 = increments.sum(dim=-2)
    if depth == 1:
        return s1
    if depth != 2:
        raise ValueError("only depth 1 and 2 are supported")
    # prefix_k = sum_{l<k} D_l; S2 = sum_k prefix_k (x) D_k + 0.5 D_k (x) D_k,
    # whose antisymmetric part is the Levy area
    prefix = torch.cumsum(increments, dim=-2) - increments
    outer = torch.einsum("...ki,...kj->...ij", prefix, increments)
    area = 0.5 * (outer - outer.transpose(-1, -2))
    c = xs.shape[-1]
    iu, ju = torch.triu_indices(c, c, offset=1, device=xs.device)
    return torch.cat([s1, area[..., iu, ju]], dim=-1)


def logsig_windows(xs: torch.Tensor, ts: torch.Tensor, depth: int = 2,
                   window: int = 20):
    """Compress a path into non-overlapping log-signature windows (the
    log-ODE method). xs (..., T, C), ts (..., T) knot times. Returns
    ``(ys (..., W+1, logsig_dim), t_new (..., W+1))``: a piecewise-linear
    path whose segment increments are the windows' log-signatures, and the
    window-boundary times. A trailing partial window is kept."""
    T = xs.shape[-2]
    if T < 2:
        raise ValueError("need at least 2 observations")
    bounds = list(range(0, T - 1, window)) + [T - 1]
    sigs = torch.stack([logsignature(xs[..., b0:b1 + 1, :], depth)
                        for b0, b1 in zip(bounds[:-1], bounds[1:])], dim=-2)
    ys = torch.cat([torch.zeros_like(sigs[..., :1, :]), torch.cumsum(sigs, dim=-2)], dim=-2)
    return ys, ts[..., bounds]
