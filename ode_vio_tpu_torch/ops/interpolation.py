"""Continuous control paths for neural CDEs and their inference solve
(counterpart of ``ode_vio_tpu/ops/interpolation.py``).

A path is a NamedTuple of knot times and per-segment polynomial
coefficients, with any leading batch dimensions: ``ts (..., T)``, the
coefficients ``(..., T-1, C)``. ``evaluate``/``derivative`` take ``t`` of
shape ``(...)``, one time per path, and pick each path's segment as
``clip(searchsorted(ts, t, 'right') - 1, 0, T-2)``.

The CDE ``dz = g(z) dX(t)`` reduces to the ODE ``z' = g(z) @ X'(t)``,
solved per row on the port's solver core: the inference solve (``while``
mode) or, for training, the bounded differentiable solve (``bounded``
mode, ``solve_ivp_batched_dt``). The adjoint mode of the JAX module is
not ported yet (ROADMAP.md, Queue 1 item 2).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ode_vio_tpu_torch.ops.solvers.odeint import (SolverOptions, Stats, solve_ivp_batched_dt,
                                                  solve_ivp_dt)


class InterpolatedPath(NamedTuple):
    """Piecewise-cubic path ``X(t) = a + b*s + c*s^2 + d*s^3`` with
    ``s = t - ts[k]`` on segment ``k``; linear paths have zero ``c``/``d``."""

    ts: torch.Tensor  # (..., T) knot times, ascending
    a: torch.Tensor   # (..., T-1, C)
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor

    def _segment(self, t: torch.Tensor):
        t = torch.as_tensor(t, dtype=self.ts.dtype, device=self.ts.device)
        k = (self.ts <= t[..., None]).sum(-1) - 1
        k = k.clamp(0, self.ts.shape[-1] - 2)
        return k, t - self.ts.gather(-1, k[..., None])[..., 0]

    @staticmethod
    def _at(coef: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        idx = k[..., None, None].expand(k.shape + (1, coef.shape[-1]))
        return coef.gather(-2, idx)[..., 0, :]

    def evaluate(self, t) -> torch.Tensor:
        """X(t); outside [t0, t1] the boundary polynomials extend."""
        k, s = self._segment(t)
        s = s[..., None]
        return ((self._at(self.d, k) * s + self._at(self.c, k)) * s
                + self._at(self.b, k)) * s + self._at(self.a, k)

    def derivative(self, t) -> torch.Tensor:
        """dX/dt at t."""
        k, s = self._segment(t)
        s = s[..., None]
        return (3.0 * self._at(self.d, k) * s + 2.0 * self._at(self.c, k)) * s \
            + self._at(self.b, k)


def _safe_dt(ts: torch.Tensor) -> torch.Tensor:
    dt = (ts[..., 1:] - ts[..., :-1])[..., None]
    return torch.where(dt > 0, dt, torch.ones_like(dt))


def linear_path(ts: torch.Tensor, xs: torch.Tensor) -> InterpolatedPath:
    """Piecewise-linear interpolation of ``xs`` (..., T, C) at ``ts``
    (..., T). A repeated knot (zero-length segment) divides by 1 instead
    of 0: between equal observations, as the history buffers' collapsed
    prefixes are, its slope is 0."""
    b = (xs[..., 1:, :] - xs[..., :-1, :]) / _safe_dt(ts)
    zeros = torch.zeros_like(b)
    return InterpolatedPath(ts=ts, a=xs[..., :-1, :], b=b, c=zeros, d=zeros)


def cubic_hermite_path(ts: torch.Tensor, xs: torch.Tensor) -> InterpolatedPath:
    """C^1 cubic-Hermite spline with backward-difference knot derivatives
    ``m_k = (x_k - x_{k-1}) / (t_k - t_{k-1})``, ``m_0 = m_1``."""
    h = _safe_dt(ts)
    diffs = (xs[..., 1:, :] - xs[..., :-1, :]) / h
    m = torch.cat([diffs[..., :1, :], diffs], dim=-2)
    m0, m1 = m[..., :-1, :], m[..., 1:, :]
    x0, x1 = xs[..., :-1, :], xs[..., 1:, :]
    c = (3.0 * (x1 - x0) / h - 2.0 * m0 - m1) / h
    d = (2.0 * (x0 - x1) / h + m0 + m1) / (h * h)
    return InterpolatedPath(ts=ts, a=x0, b=m0, c=c, d=d)


def make_path(ts, xs, kind: str = "linear") -> InterpolatedPath:
    if kind == "linear":
        return linear_path(ts, xs)
    if kind == "cubic":
        return cubic_hermite_path(ts, xs)
    raise ValueError(f"unknown interpolation '{kind}'")


def cdeint_path(func: Callable[[torch.Tensor], torch.Tensor], z0: torch.Tensor,
                path: InterpolatedPath, eval_ts: torch.Tensor,
                opts: SolverOptions = SolverOptions(), bounded: bool = False):
    """Solve ``dz = func(z) dX(t)`` for every row of ``z0`` (B, H) on its
    own path (``path.ts`` (B, T)) through ``[path.ts[:, 0]] + eval_ts``
    (B, E), segment by segment: each segment a fresh solve with its own
    ``max_steps`` budget, the step size carried over from the previous
    one (``opts.dt0`` at the start). ``func(z)`` is (B, H, C).
    ``bounded``: each segment is the training solve
    (``solve_ivp_batched_dt``: an early-exit check per ``exit_chunk``
    steps, recorded by autograd), else the inference solve.

    Returns ``(zs (B, E, H), dt_final (B,), Stats)`` with the per-row
    counts summed over segments: the counterpart of ``cdeint_batched``,
    plus the last step proposal.
    """
    def field(t, z):
        return (func(z) @ path.derivative(t)[..., None])[..., 0]

    solve = solve_ivp_batched_dt if bounded else solve_ivp_dt
    seg_t0 = torch.cat([path.ts[:, :1], eval_ts[:, :-1]], dim=1)
    z = z0
    dt = torch.full((z0.shape[0],), opts.dt0, dtype=torch.float32, device=z0.device)
    zs, acc, rej, inc = [], 0, 0, 0
    for j in range(eval_ts.shape[1]):
        z, dt, st = solve(field, z, seg_t0[:, j], eval_ts[:, j], opts, dt)
        zs.append(z)
        acc, rej, inc = acc + st.accepted, rej + st.rejected, inc + st.incomplete
    return torch.stack(zs, dim=1), dt, Stats(acc, rej, inc)


def cdeint_batched(func, z0, ts, xs, eval_ts, kind: str,
                   opts: SolverOptions = SolverOptions(), bounded: bool = False):
    """:func:`cdeint_path` on the paths ``make_path(ts, xs, kind)``, ts
    (B, T), xs (B, T, C): JAX's ``cdeint_batched`` in ``while`` mode, or
    with ``bounded`` in ``bounded`` mode (training; gradients reach
    ``z0``, ``xs`` and the field's weights). Returns ``(zs (B, E, H),
    Stats)`` with per-row (B,) counts summed over segments."""
    zs, _, stats = cdeint_path(func, z0, make_path(ts, xs, kind), eval_ts, opts, bounded)
    return zs, stats


def cdeint_fused(layers, activation: str, z0, ts, xs, eval_ts, kind: str,
                 opts: SolverOptions):
    """The same solve through kernel K2 (``ops/cuda_kernels.py::
    fused_cde_solve``), the field ``apply_cde_func(layers, z, activation)``.
    Returns ``(zs (B, E, H), Stats)``."""
    from ode_vio_tpu_torch.ops.cuda_kernels import fused_cde_solve

    path = make_path(ts.contiguous(), xs, kind)
    cubic = kind == "cubic"
    zs, _, acc, rej, inc = fused_cde_solve(
        layers, z0.contiguous(), path.ts, path.b, path.c if cubic else None,
        path.d if cubic else None, eval_ts.contiguous(), activation=activation,
        method=opts.method, rtol=opts.rtol, atol=opts.atol, dt0=opts.dt0,
        max_steps=opts.max_steps, safety=opts.safety,
        factor_min=opts.factor_min, factor_max=opts.factor_max)
    return zs, Stats(acc, rej, inc)
