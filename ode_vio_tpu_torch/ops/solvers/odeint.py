"""Explicit-RK integration over rows (counterpart of
``ode_vio_tpu/ops/solvers/odeint.py``).

One generic stepper over a :class:`ButcherTableau`, the integral step
controller with the torchdiffeq/torchode semantics (RMS error norm over
``err / (atol + rtol*max(|y0|,|y1|))``, growth factor
``safety * ratio**(-1/order)`` clipped to ``[factor_min, factor_max]``),
and the solves of the JAX module, batched over rows with per-row step
sizes and per-row masking, step for step the values of
``jax.vmap(solve_ivp_dt)``:

* :func:`solve_ivp_dt`, inference (``while`` mode): the host checks after
  every step whether any row is still active;
* :func:`solve_ivp_batched_dt`, training (``bounded`` mode, JAX's
  ``solve_ivp_batched_dt``): the same masked steps, recorded by autograd,
  with the check once per ``exit_chunk`` steps and at most ``max_steps``.
  The chunks after every row is done never run, so autograd records none
  of them; JAX's per-chunk remat, there because its scan keeps residuals
  even for the chunks it skips, is not needed;
* the fixed-step solve (``adaptive=False``: ``fixed_steps`` equal steps)
  and the fixed-grid Adams methods (:data:`MULTISTEP_METHODS`), which
  both solves take when the options say so;
* :func:`solve_at_dt`, through a row's knots with the step size carried;
* :func:`solve_ivp_adjoint` (``adjoint`` mode), the continuous adjoint:
  an inference solve forward, and backward one reverse solve of the
  augmented state per row, as ``jax.vmap`` of JAX's ``jax.custom_vjp``.

:func:`solve_ivp`, :func:`solve_at` and :func:`initial_step_size` are
parity API: no path of the port calls them; they exist to match the JAX
package's public solver functions and are held against them by the tests.

The controller's decisions are constants of the computation: the error
ratio and the step size are detached, as JAX stops their gradients, so
gradients flow through the accepted RK stages only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau

VectorField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # f(t, y)

_SAFE_RATIO_FLOOR = 1e-10
_TINY = torch.finfo(torch.float32).tiny

# torchdiffeq's fixed-grid linear-multistep method strings: they imply the
# fixed-step solve (rtol and atol are ignored), as in JAX
MULTISTEP_METHODS = ("explicit_adams", "implicit_adams")

# The host's checks for an active row, each of which waits for the device:
# both solves (solve_ivp_dt after every step, solve_ivp_batched_dt once per
# chunk) count here. Read it as ``odeint.host_syncs``.
host_syncs = 0
# rows of solve_ivp_adjoint's backward solves that ran out of max_steps
# before their interval's start (JAX hides them; read as
# ``odeint.adjoint_incomplete``)
adjoint_incomplete = 0


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    method: str = "dopri5"
    rtol: float = 1e-2
    atol: float = 1e-6
    dt0: float = 1e-4
    max_steps: int = 64
    adaptive: bool = True
    fixed_steps: int = 4
    unroll_mode: str = "bounded"  # 'bounded' | 'while' | 'adjoint'
    safety: float = 0.9
    factor_min: float = 0.2
    factor_max: float = 10.0
    exit_chunk: int = 4  # solve_ivp_batched_dt: steps per early-exit check

    def __post_init__(self):
        # the Adams method strings are fixed-step whatever `adaptive` says
        if self.method in MULTISTEP_METHODS:
            object.__setattr__(self, "adaptive", False)

    @classmethod
    def from_config(cls, cfg, train: bool = False) -> "SolverOptions":
        """From a :class:`ode_vio_tpu_torch.config.SolverConfig`: the
        inference solve's options (budget ``max_steps``, mode ``'while'``),
        or with ``train`` the training budget ``max_steps_train`` and the
        configured training mode (``'adjoint'`` or the bounded solve)."""
        return cls(
            method=cfg.method, rtol=cfg.rtol, atol=cfg.atol, dt0=cfg.dt0,
            max_steps=cfg.max_steps_train if train else cfg.max_steps,
            adaptive=cfg.adaptive, fixed_steps=cfg.fixed_steps,
            unroll_mode=cfg.unroll_mode if train else "while",
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
    ``(t, y, f, dt, accept)`` and the step taken; the caller masks rows
    that are done."""
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
    return t_new, y_new, f_new, dt_next, accept, dtc


def _rows(x, n: int, device) -> torch.Tensor:
    """A scalar or (N,) time as a float32 (N,) tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n)


def _solve(func: VectorField, y0: torch.Tensor, t0, t1, opts: SolverOptions,
           dt0, chunk: int, n_chunks: int, log: Optional[list] = None):
    """Masked steps on every row, ``chunk`` at a time, at most ``n_chunks``
    chunks; the host checks before each chunk whether any row is active.
    ``log`` gets every attempt: (N, 2) (t, h) per row, h negated where the
    step was rejected, (0, 0) where the row made none."""
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
            t_n, y_n, f_n, dt_n, accept, dtc = _adaptive_step_body(
                func, t1, opts, t, y, f, dt)
            if log is not None:
                h = torch.where(accept, dtc, -dtc).detach()
                log.append(torch.stack([torch.where(on, t, 0.0), torch.where(on, h, 0.0)], -1))
            a = on[:, None]
            t = torch.where(on, t_n, t)
            y = torch.where(a, y_n, y)
            f = torch.where(a, f_n, f)
            dt = torch.where(on, dt_n, dt)
            acc = acc + (accept & on).to(torch.int32)
            rej = rej + (~accept & on).to(torch.int32)

    incomplete = ((t1 - t) > 0.0).to(torch.int32)
    return y, dt, Stats(acc, rej, incomplete)


def _solve_fixed_adams(func: VectorField, y0, t0, t1, opts: SolverOptions):
    """``opts.fixed_steps`` equal steps of order-4 Adams: torchdiffeq's
    fixed-grid ``explicit_adams`` (Adams-Bashforth) and ``implicit_adams``
    (Adams-Bashforth-Moulton PECE, one corrector sweep). As in JAX, the
    first ``min(3, n)`` steps are RK4 steps, not torchdiffeq's order ramp:

    * predictor: y* = y + dt/24 (55 f_k - 59 f_{k-1} + 37 f_{k-2} - 9 f_{k-3})
    * corrector (implicit_adams): y_{k+1} = y + dt/24 (9 f(t_{k+1}, y*)
      + 19 f_k - 5 f_{k-1} + f_{k-2})
    """
    n = opts.fixed_steps
    dt = (t1 - t0) / n
    dtc = dt[:, None]
    rk4 = get_tableau("rk4")
    y, hist = y0, []  # f(t_k, y_k), oldest first
    for k in range(min(3, n)):
        t = t0 + k * dt
        hist.append(func(t, y))
        y, _, _ = rk_step(func, t, y, dt, rk4, None)
    if n > 3:
        fm1, fm2, fm3 = hist[2], hist[1], hist[0]
        for k in range(3, n):
            t = t0 + k * dt
            f0 = func(t, y)
            y_pred = y + dtc * _weighted_sum((55 / 24, -59 / 24, 37 / 24, -9 / 24),
                                             (f0, fm1, fm2, fm3))
            if opts.method == "implicit_adams":
                fp = func(t + dt, y_pred)
                y = y + dtc * _weighted_sum((9 / 24, 19 / 24, -5 / 24, 1 / 24),
                                            (fp, f0, fm1, fm2))
            else:
                y = y_pred
            fm1, fm2, fm3 = f0, fm1, fm2
    return y, dt


def _solve_fixed(func: VectorField, y0: torch.Tensor, t0, t1, opts: SolverOptions):
    """``opts.fixed_steps`` equal steps per row of ``opts.method`` (any
    tableau, or an Adams method), each row over its own interval. The
    counts are (fixed_steps, 0, 0); the returned step is (t1 - t0) / n."""
    n_rows, dev = y0.shape[0], y0.device
    t0, t1 = _rows(t0, n_rows, dev), _rows(t1, n_rows, dev)
    if opts.method in MULTISTEP_METHODS:
        y, dt = _solve_fixed_adams(func, y0, t0, t1, opts)
    else:
        tab = opts.tableau
        dt = (t1 - t0) / opts.fixed_steps
        y = y0
        f = func(t0, y0) if tab.fsal else None
        for k in range(opts.fixed_steps):
            y, _, k_last = rk_step(func, t0 + k * dt, y, dt, tab, f)
            f = k_last if tab.fsal else None
    zero = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    return y, dt, Stats(zero + opts.fixed_steps, zero, zero)


def solve_ivp_dt(func: VectorField, y0: torch.Tensor, t0, t1,
                 opts: SolverOptions = SolverOptions(), dt0=None,
                 log: Optional[list] = None):
    """Integrate ``dy/dt = func(t, y)`` for every row of ``y0`` (N, F)
    from ``t0`` to ``t1 >= t0`` ((N,) each), each row with its own step
    size, starting from ``dt0`` (scalar or (N,); default ``opts.dt0``).

    A row stops when it reaches ``t1`` or has taken ``max_steps`` steps;
    rows that are done keep their values while the others go on, and the
    loop ends at the first step where no row is active. Returns ``(y1,
    dt_final, stats)``: ``dt_final`` is the controller's next proposal,
    which warm-starts the next interval's solve. Options that are not
    adaptive (or an Adams method) take the fixed-step solve instead. An
    adaptive solve appends its attempts to ``log`` (:func:`_solve`).
    """
    if opts.unroll_mode == "adjoint":
        raise ValueError("use solve_ivp_adjoint() for the continuous-adjoint mode "
                         "(it needs explicit params)")
    if not opts.adaptive:
        return _solve_fixed(func, y0, t0, t1, opts)
    # a row active at step k has taken k steps: max_steps + 1 checks end it
    return _solve(func, y0, t0, t1, opts, dt0, 1, opts.max_steps + 1, log)


def solve_ivp(func: VectorField, y0: torch.Tensor, t0, t1,
              opts: SolverOptions = SolverOptions(), dt0=None):
    """:func:`solve_ivp_dt` without the final step proposal: ``(y1, stats)``."""
    y1, _, stats = solve_ivp_dt(func, y0, t0, t1, opts, dt0)
    return y1, stats


def solve_ivp_batched_dt(func: VectorField, y0: torch.Tensor, t0, t1,
                         opts: SolverOptions = SolverOptions(), dt0=None):
    """The training solve: :func:`solve_ivp_dt`'s values and per-row
    counts, with the host's check for an early exit once per chunk of
    ``opts.exit_chunk`` steps (<= 0: one chunk of ``max_steps``), as
    JAX's bounded ``solve_ivp_batched_dt`` skips whole chunks once every
    row is done. Autograd records the chunks that ran. Options that are
    not adaptive take :func:`solve_ivp_dt`'s fixed-step solve.
    """
    if not opts.adaptive or opts.unroll_mode == "adjoint":
        return solve_ivp_dt(func, y0, t0, t1, opts, dt0)
    chunk = opts.max_steps if opts.exit_chunk <= 0 else min(opts.exit_chunk, opts.max_steps)
    return _solve(func, y0, t0, t1, opts, dt0, chunk, -(-opts.max_steps // chunk))


def solve_at_dt(func: VectorField, y0: torch.Tensor, ts: torch.Tensor,
                opts: SolverOptions = SolverOptions(), bounded: bool = False,
                log: Optional[list] = None):
    """Integrate every row of ``y0`` (N, F) through its knots ``ts``
    (N, T), ``y0`` at ``ts[:, 0]``: one solve per segment, each with its
    own ``max_steps`` budget, the step size carried from one segment to the
    next (``opts.dt0`` at the start). ``bounded``: each segment is the
    training solve (:func:`solve_ivp_batched_dt`), else the inference solve.
    Returns ``(ys (N, T-1, F), dt_final (N,), Stats)`` with the per-row
    counts summed over segments. ``log`` (the inference solve only) gets
    one list of attempts a segment (:func:`_solve`)."""
    if bounded and log is not None:
        raise ValueError("the training solve's attempts are not logged")
    y = y0
    dt = torch.full((y0.shape[0],), opts.dt0, dtype=torch.float32, device=y0.device)
    solve = solve_ivp_batched_dt if bounded else solve_ivp_dt
    ys, acc, rej, inc = [], 0, 0, 0
    for j in range(ts.shape[1] - 1):
        kw = {}
        if log is not None:
            log.append([])
            kw["log"] = log[-1]
        y, dt, st = solve(func, y, ts[:, j], ts[:, j + 1], opts, dt, **kw)
        ys.append(y)
        acc, rej, inc = acc + st.accepted, rej + st.rejected, inc + st.incomplete
    return torch.stack(ys, dim=1), dt, Stats(acc, rej, inc)


def solve_at(func: VectorField, y0: torch.Tensor, ts: torch.Tensor,
             opts: SolverOptions = SolverOptions()):
    """The states at ``ts[:, 1:]`` and the counts summed over segments:
    :func:`solve_at_dt` without the last step proposal, JAX's ``solve_at``
    over rows."""
    ys, _, stats = solve_at_dt(func, y0, ts, opts)
    return ys, stats


# ---------------------------------------------------------------------------
# Continuous adjoint (optimize-then-discretize)
# ---------------------------------------------------------------------------

def solve_ivp_adjoint(func, opts: SolverOptions, y0: torch.Tensor, t0, t1,
                      args: Sequence[torch.Tensor], lane_args: Sequence[torch.Tensor] = ()):
    """Adjoint-mode solve of every row of ``y0`` (N, F) from ``t0`` to
    ``t1`` ((N,) each). ``func(t, y, args, lane_args)`` takes the
    differentiable parameters explicitly: ``args`` are shared by every row
    (a field's weights), ``lane_args`` carry a leading row axis (a row's
    control path).

    Forward: the inference solve from ``opts.dt0`` with budget
    ``opts.max_steps``, under no_grad; it keeps ``y0, y1, t0, t1``.
    Backward: per row, one reverse solve of the augmented state
    ``(y, a, args_bar)`` from ``s = 0`` to ``t1 - t0`` with the dynamics
    ``(-f, a.df/dy, a.df/dargs)`` (``t = t1 - s``) and the same method,
    tolerances and budget, each row's error norm over its whole augmented
    state, its own ``args_bar`` included, as ``jax.vmap`` of JAX's
    ``jax.custom_vjp`` makes it; the rows' ``args_bar`` are summed at the
    end. Returns ``y1`` (N, F); no counts (JAX hides the adjoint's)."""
    return _Adjoint.apply(func, opts, len(args), y0, _rows(t0, y0.shape[0], y0.device),
                          _rows(t1, y0.shape[0], y0.device), *args, *lane_args)


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, opts, n_args, y0, t0, t1, *tensors):
        args, lane = tensors[:n_args], tensors[n_args:]
        inference = dataclasses.replace(opts, unroll_mode="while")
        y1, _, _ = solve_ivp_dt(lambda t, y: func(t, y, args, lane), y0, t0, t1, inference)
        ctx.func, ctx.opts, ctx.n_args = func, inference, n_args
        ctx.save_for_backward(y0, y1, t0, t1, *tensors)
        return y1

    @staticmethod
    def backward(ctx, ct_y1):
        global adjoint_incomplete
        y0, y1, t0, t1, *tensors = ctx.saved_tensors
        func, n_args = ctx.func, ctx.n_args
        args, lane = tuple(tensors[:n_args]), tuple(tensors[n_args:])
        n, feat = y1.shape

        def row_vjp(t, y, a, params, lane_row):
            def f(yy, pp, ll):
                return func(t[None], yy[None], pp, tuple(x[None] for x in ll))[0]

            out, pull = torch.func.vjp(f, y, params, lane_row)
            return (out, *pull(a))

        vjp_rows = torch.func.vmap(row_vjp, in_dims=(0, 0, 0, None, 0))
        sizes = [x.numel() for x in args] + [x[0].numel() for x in lane]

        def aug_dot(s, aug):
            y, a = aug[:, :feat], aug[:, feat:2 * feat]
            f, df_dy, df_dargs, df_dlane = vjp_rows(t1 - s, y, a, args, lane)
            return torch.cat([-f, df_dy, *(g.reshape(n, -1) for g in df_dargs),
                              *(g.reshape(n, -1) for g in df_dlane)], dim=1)

        with torch.no_grad():
            aug0 = torch.cat([y1, ct_y1, y1.new_zeros(n, sum(sizes))], dim=1)
            span = t1 - t0
            aug, _, stats = solve_ivp_dt(aug_dot, aug0, torch.zeros_like(span), span, ctx.opts)
            adjoint_incomplete += int(stats.incomplete.sum())
            a_y0 = aug[:, feat:2 * feat]
            bars = torch.split(aug[:, 2 * feat:], sizes, dim=1)
            t1_bar = (ct_y1 * func(t1, y1, args, lane)).sum(-1)
            t0_bar = -(a_y0 * func(t0, y0, args, lane)).sum(-1)
            args_bar = [g.sum(0).reshape(x.shape) for g, x in zip(bars, args)]
            lane_bar = [g.reshape(x.shape) for g, x in zip(bars[n_args:], lane)]
        return (None, None, None, a_y0, t0_bar, t1_bar, *args_bar, *lane_bar)


# ---------------------------------------------------------------------------
# Initial step-size heuristic (Hairer, Norsett & Wanner)
# ---------------------------------------------------------------------------

def initial_step_size(func: VectorField, y0: torch.Tensor, t0, order: int,
                      rtol: float, atol: float) -> torch.Tensor:
    """A first step size (N,) for every row of ``y0`` (N, F): an optional
    alternative to the fixed ``dt0`` (JAX's ``initial_step_size``, its
    norms per row)."""
    t0 = _rows(t0, y0.shape[0], y0.device)
    f0 = func(t0, y0)
    scale = atol + y0.abs() * rtol

    def norm(x):
        return torch.sqrt((x * x).sum(-1) / x.shape[-1])

    d0, d1 = norm(y0 / scale), norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = func(t0 + h0, y0 + h0[:, None] * f0)
    d2 = norm((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / dmax) ** (1.0 / (order + 1.0)))
    return torch.minimum(100.0 * h0, h1)
