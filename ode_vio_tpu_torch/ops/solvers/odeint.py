"""Adaptive explicit-RK integration, inference (``while``) mode
(counterpart of ``ode_vio_tpu/ops/solvers/odeint.py``).

One generic stepper over a :class:`ButcherTableau`, the integral step
controller with the torchdiffeq/torchode semantics (RMS error norm over
``err / (atol + rtol*max(|y0|,|y1|))``, growth factor
``safety * ratio**(-1/order)`` clipped to ``[factor_min, factor_max]``),
and :func:`solve_ivp_dt`, a solve batched over rows with per-row step
sizes and per-row masking: the counterpart of
``jax.vmap(solve_ivp_dt)``, step for step.

The bounded, adjoint, fixed-step and Adams modes of the JAX module belong
to training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch

from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau

VectorField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # f(t, y)

_SAFE_RATIO_FLOOR = 1e-10
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    method: str = "dopri5"
    rtol: float = 1e-2
    atol: float = 1e-6
    dt0: float = 1e-4
    max_steps: int = 64
    safety: float = 0.9
    factor_min: float = 0.2
    factor_max: float = 10.0

    @classmethod
    def from_config(cls, cfg) -> "SolverOptions":
        """From a :class:`ode_vio_tpu_torch.config.SolverConfig`, with the
        inference step budget ``max_steps``."""
        return cls(
            method=cfg.method, rtol=cfg.rtol, atol=cfg.atol, dt0=cfg.dt0,
            max_steps=cfg.max_steps, safety=cfg.safety, factor_min=cfg.factor_min,
            factor_max=cfg.factor_max,
        )

    @property
    def tableau(self) -> ButcherTableau:
        return get_tableau(self.method)


class Stats(NamedTuple):
    """Per-row int32 step counts; ``incomplete`` is 1 where the row ran
    out of ``max_steps`` before reaching ``t1``."""

    accepted: torch.Tensor
    rejected: torch.Tensor
    incomplete: torch.Tensor


def _weighted_sum(coeffs: Sequence[float], ks: Sequence[torch.Tensor]):
    """sum_i coeffs[i] * ks[i], skipping zero coefficients; None if all
    are zero."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c == 0.0:
            continue
        acc = c * k if acc is None else acc + c * k
    return acc


def rk_step(func: VectorField, t, y, dt, tab: ButcherTableau, f0=None):
    """One explicit RK step over rows. ``t``, ``dt``: (N,). Returns
    ``(y1, err, k_last)``; ``k_last`` equals f(t+dt, y1) for FSAL methods."""
    dtc = dt[:, None]
    ks = [f0 if (tab.fsal and f0 is not None) else func(t, y)]
    for i in range(1, tab.num_stages):
        incr = _weighted_sum(tab.a[i], ks)
        yi = y if incr is None else y + dtc * incr
        ks.append(func(t + tab.c[i] * dt, yi))
    y1 = y + dtc * _weighted_sum(tab.b_sol, ks)
    err = (dtc * _weighted_sum(tab.b_err, ks) if tab.b_err is not None
           else torch.zeros_like(y))
    return y1, err, ks[-1]


def _error_ratio(err, y0, y1, rtol: float, atol: float) -> torch.Tensor:
    """Per-row RMS norm of the scaled error."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    r = err / scale
    return torch.sqrt((r * r).sum(dim=-1) / y0.shape[-1])


def _adaptive_step_body(func, t1, opts: SolverOptions, t, y, f, dt):
    """One controller step on every row. Returns the new
    ``(t, y, f, dt, accept)``; the caller masks rows that are done."""
    tab = opts.tableau
    remaining = torch.clamp_min(t1 - t, 0.0)
    clamped = dt >= remaining
    dtc = torch.where(clamped, remaining, dt)

    y1, err, k_last = rk_step(func, t, y, dtc, tab, f)
    ratio = _error_ratio(err, y, y1, opts.rtol, opts.atol)
    accept = ratio <= 1.0

    safe = torch.clamp_min(ratio, _SAFE_RATIO_FLOOR)
    factor = torch.clamp(opts.safety * safe ** (-1.0 / tab.order),
                         opts.factor_min, opts.factor_max)
    dt_next = torch.clamp_min(dtc * factor, _TINY)

    t_new = torch.where(accept, torch.where(clamped, t1, t + dtc), t)
    a = accept[:, None]
    y_new = torch.where(a, y1, y)
    f_new = torch.where(a, k_last, f) if tab.fsal else f
    return t_new, y_new, f_new, dt_next, accept


def solve_ivp_dt(func: VectorField, y0: torch.Tensor, t0, t1,
                 opts: SolverOptions = SolverOptions(), dt0=None):
    """Integrate ``dy/dt = func(t, y)`` for every row of ``y0`` (N, F)
    from ``t0`` to ``t1 >= t0`` ((N,) each), each row with its own step
    size, starting from ``dt0`` (scalar or (N,); default ``opts.dt0``).

    A row stops when it reaches ``t1`` or has taken ``max_steps`` steps;
    rows that are done keep their values while the others go on.
    Returns ``(y1, dt_final, stats)``: ``dt_final`` is the controller's
    next proposal, which warm-starts the next interval's solve.
    """
    tab = opts.tableau
    if not tab.adaptive_capable:
        raise ValueError(f"the adaptive solve needs a method with an error "
                         f"estimate, not '{opts.method}'")
    n = y0.shape[0]
    t = torch.as_tensor(t0, dtype=torch.float32, device=y0.device).expand(n).clone()
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=y0.device).expand(n)
    dt = torch.as_tensor(opts.dt0 if dt0 is None else dt0,
                         dtype=torch.float32, device=y0.device).expand(n).clone()
    y = y0
    f = func(t, y) if tab.fsal else torch.zeros_like(y)
    acc = torch.zeros(n, dtype=torch.int32, device=y0.device)
    rej = torch.zeros_like(acc)

    while True:
        active = ((t1 - t) > 0.0) & (acc + rej < opts.max_steps)
        if not bool(active.any()):
            break
        t_n, y_n, f_n, dt_n, accept = _adaptive_step_body(
            func, t1, opts, t, y, f, dt)
        a = active[:, None]
        t = torch.where(active, t_n, t)
        y = torch.where(a, y_n, y)
        f = torch.where(a, f_n, f)
        dt = torch.where(active, dt_n, dt)
        acc = acc + (accept & active).to(torch.int32)
        rej = rej + (~accept & active).to(torch.int32)

    incomplete = ((t1 - t) > 0.0).to(torch.int32)
    return y, dt, Stats(acc, rej, incomplete)

