"""Adaptive explicit-RK integration over rows (counterpart of
``ode_vio_tpu/ops/solvers/odeint.py``).

One generic stepper over a :class:`ButcherTableau`, the integral step
controller with the torchdiffeq/torchode semantics (RMS error norm over
``err / (atol + rtol*max(|y0|,|y1|))``, growth factor
``safety * ratio**(-1/order)`` clipped to ``[factor_min, factor_max]``),
and two solves batched over rows with per-row step sizes and per-row
masking, step for step the values of ``jax.vmap(solve_ivp_dt)``:

* :func:`solve_ivp_dt`, inference (``while`` mode): the host checks after
  every step whether any row is still active;
* :func:`solve_ivp_batched_dt`, training (``bounded`` mode, JAX's
  ``solve_ivp_batched_dt``): the same masked steps, recorded by autograd,
  with the check once per ``exit_chunk`` steps and at most ``max_steps``.

The controller's decisions are constants of the computation: the error
ratio and the step size are detached, as JAX stops their gradients, so
gradients flow through the accepted RK stages only.

The adjoint, fixed-step and Adams modes of the JAX module are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch

from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau

VectorField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # f(t, y)

_SAFE_RATIO_FLOOR = 1e-10
_TINY = torch.finfo(torch.float32).tiny

# The host's checks for an active row, each of which waits for the device:
# both solves (solve_ivp_dt after every step, solve_ivp_batched_dt once per
# chunk) count here. Read it as ``odeint.host_syncs``.
host_syncs = 0


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
    exit_chunk: int = 4  # solve_ivp_batched_dt: steps per early-exit check

    @classmethod
    def from_config(cls, cfg, train: bool = False) -> "SolverOptions":
        """From a :class:`ode_vio_tpu_torch.config.SolverConfig`: the
        inference step budget ``max_steps``, or with ``train`` the training
        budget ``max_steps_train``."""
        if train and cfg.unroll_mode == "adjoint":
            raise NotImplementedError(
                "the continuous adjoint is not ported yet (ROADMAP.md, Queue 1 "
                "item 2); train with unroll_mode='bounded'")
        return cls(
            method=cfg.method, rtol=cfg.rtol, atol=cfg.atol, dt0=cfg.dt0,
            max_steps=cfg.max_steps_train if train else cfg.max_steps,
            safety=cfg.safety, factor_min=cfg.factor_min,
            factor_max=cfg.factor_max, exit_chunk=cfg.exit_chunk,
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
    # the controller's decisions are constants of the computation
    ratio = _error_ratio(err, y, y1, opts.rtol, opts.atol).detach()
    accept = ratio <= 1.0

    safe = torch.clamp_min(ratio, _SAFE_RATIO_FLOOR)
    factor = torch.clamp(opts.safety * safe ** (-1.0 / tab.order),
                         opts.factor_min, opts.factor_max)
    dt_next = torch.clamp_min(dtc.detach() * factor, _TINY)

    t_new = torch.where(accept, torch.where(clamped, t1, t + dtc), t)
    a = accept[:, None]
    y_new = torch.where(a, y1, y)
    f_new = torch.where(a, k_last, f) if tab.fsal else f
    return t_new, y_new, f_new, dt_next, accept


def _solve(func: VectorField, y0: torch.Tensor, t0, t1, opts: SolverOptions,
           dt0, chunk: int, n_chunks: int):
    """Masked steps on every row, ``chunk`` at a time, at most ``n_chunks``
    chunks; the host checks before each chunk whether any row is active."""
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

    def active():
        return ((t1 - t) > 0.0) & (acc + rej < opts.max_steps)

    global host_syncs
    for _ in range(n_chunks):
        on = active()
        host_syncs += 1
        if not bool(on.any()):
            break
        for i in range(chunk):
            if i:
                on = active()
            t_n, y_n, f_n, dt_n, accept = _adaptive_step_body(
                func, t1, opts, t, y, f, dt)
            a = on[:, None]
            t = torch.where(on, t_n, t)
            y = torch.where(a, y_n, y)
            f = torch.where(a, f_n, f)
            dt = torch.where(on, dt_n, dt)
            acc = acc + (accept & on).to(torch.int32)
            rej = rej + (~accept & on).to(torch.int32)

    incomplete = ((t1 - t) > 0.0).to(torch.int32)
    return y, dt, Stats(acc, rej, incomplete)


def solve_ivp_dt(func: VectorField, y0: torch.Tensor, t0, t1,
                 opts: SolverOptions = SolverOptions(), dt0=None):
    """Integrate ``dy/dt = func(t, y)`` for every row of ``y0`` (N, F)
    from ``t0`` to ``t1 >= t0`` ((N,) each), each row with its own step
    size, starting from ``dt0`` (scalar or (N,); default ``opts.dt0``).

    A row stops when it reaches ``t1`` or has taken ``max_steps`` steps;
    rows that are done keep their values while the others go on, and the
    loop ends at the first step where no row is active. Returns ``(y1,
    dt_final, stats)``: ``dt_final`` is the controller's next proposal,
    which warm-starts the next interval's solve.
    """
    # a row active at step k has taken k steps: max_steps + 1 checks end it
    return _solve(func, y0, t0, t1, opts, dt0, 1, opts.max_steps + 1)


def solve_ivp_batched_dt(func: VectorField, y0: torch.Tensor, t0, t1,
                         opts: SolverOptions = SolverOptions(), dt0=None):
    """The training solve: :func:`solve_ivp_dt`'s values and per-row
    counts, with the host's check for an early exit once per chunk of
    ``opts.exit_chunk`` steps (<= 0: one chunk of ``max_steps``), as
    JAX's bounded ``solve_ivp_batched_dt`` skips whole chunks once every
    row is done. Autograd records the chunks that ran.
    """
    chunk = opts.max_steps if opts.exit_chunk <= 0 else min(opts.exit_chunk, opts.max_steps)
    return _solve(func, y0, t0, t1, opts, dt0, chunk, -(-opts.max_steps // chunk))
