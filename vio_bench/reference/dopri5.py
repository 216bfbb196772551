"""Dormand-Prince 5(4) with an integral step controller, over rows.

Written from the method's published tableau (Dormand & Prince, 1980) and
the controller the ODE-VIO solvers state: per-row step sizes, the RMS
norm of ``err / (atol + rtol * max(|y0|, |y1|))``, acceptance at a ratio
of at most 1, the next step ``safety * ratio**(-1/5)`` times the last,
clipped to ``[factor_min, factor_max]``, a step never past the interval's
end, at most ``max_steps`` attempts per row and interval. The first stage
of a step is the last stage of the step accepted before it (FSAL).

Plain float32 PyTorch: nothing of the measured program is imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
B_SOL = A[6] + (0.0,)
B_HAT = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
B_ERR = tuple(b - bh for b, bh in zip(B_SOL, B_HAT))
ORDER = 5
NEW_STAGES = 6  # field evaluations per attempted step (the first is the last one's)

_TINY = torch.finfo(torch.float32).tiny


@dataclass(frozen=True)
class Controller:
    rtol: float
    atol: float
    max_steps: int
    safety: float = 0.9
    factor_min: float = 0.2
    factor_max: float = 10.0


def _combine(coeffs, ks):
    out = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            out = c * k if out is None else out + c * k
    return out


def solve(field: Callable, y: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
          dt: torch.Tensor, ctl: Controller):
    """Integrate ``y' = field(t, y)`` for every row of ``y`` (N, D) from
    ``t0`` to ``t1`` ((N,) each), starting with the step ``dt`` (N,).

    Returns ``(y1, dt_next, accepted, rejected, evals)``: the states at
    ``t1`` (or where the budget ran out), each row's last step proposal,
    its accepted and rejected steps, and the field evaluations the solve
    needed (the first stage once per row that steps, six per attempt)."""
    t, dt = t0.clone(), dt.clone()
    f = field(t, y)
    acc = torch.zeros(y.shape[0], dtype=torch.int64, device=y.device)
    rej = torch.zeros_like(acc)
    while True:
        on = ((t1 - t) > 0) & (acc + rej < ctl.max_steps)
        if not bool(on.any()):
            break
        remaining = torch.clamp_min(t1 - t, 0.0)
        clamped = dt >= remaining
        h = torch.where(clamped, remaining, dt)
        hc = h[:, None]
        ks = [f]
        for i in range(1, 7):
            ks.append(field(t + C[i] * h, y + hc * _combine(A[i], ks)))
        y1 = y + hc * _combine(B_SOL, ks)
        err = hc * _combine(B_ERR, ks)
        scale = ctl.atol + ctl.rtol * torch.maximum(y.abs(), y1.abs())
        ratio = torch.sqrt(((err / scale) ** 2).mean(-1))
        accept = ratio <= 1.0
        factor = torch.clamp(ctl.safety * torch.clamp_min(ratio, 1e-10) ** (-1.0 / ORDER),
                             ctl.factor_min, ctl.factor_max)
        take = on & accept
        t = torch.where(take, torch.where(clamped, t1, t + h), t)
        y = torch.where(take[:, None], y1, y)
        f = torch.where(take[:, None], ks[6], f)
        dt = torch.where(on, torch.clamp_min(h * factor, _TINY), dt)
        acc += take.long()
        rej += (on & ~accept).long()
    stepped = (acc + rej) > 0
    evals = int(stepped.sum()) + NEW_STAGES * int((acc + rej).sum())
    return y, dt, acc, rej, evals
