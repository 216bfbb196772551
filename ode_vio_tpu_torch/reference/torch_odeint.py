"""Reference-faithful adaptive RK45 (dopri5) in torch (the port's copy of
``ode_vio_tpu/reference/torch_odeint.py::odeint_dopri5``), the solver of
the reference-protocol tester (reference/torch_tester.py).

Mirrors the torchdiffeq/torchode semantics the reference runs on (the
reference's src/models/PoseODERNN.py:55-75, PoseCDE.py:101):

* dopri5 Butcher tableau with FSAL,
* RMS error norm over ``err / (atol + rtol * max(|y0|, |y1|))``
  (torchdiffeq ``_compute_error_ratio``),
* integral controller ``factor = clip(safety * ratio**(-1/order),
  dfactor, ifactor)`` with safety 0.9, dfactor 0.2, ifactor 10
  (torchdiffeq's defaults, and the port's SolverConfig defaults),
* steps clamped to land exactly on t1, proposed dt carried across
  accept/reject.

It is independent of the port's solver core (ops/solvers/odeint.py) on
purpose: torchdiffeq and torchode are not installed, so their semantics
are re-implemented here from the published algorithm.
"""

import torch

# dopri5 tableau (Dormand & Prince 1980), public RK coefficients
_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B_SOL = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_B_ERR = [
    35 / 384 - 5179 / 57600,
    0.0,
    500 / 1113 - 7571 / 16695,
    125 / 192 - 393 / 640,
    -2187 / 6784 + 92097 / 339200,
    11 / 84 - 187 / 2100,
    -1 / 40,
]
ORDER = 5


def _rms_ratio(err, y0, y1, rtol, atol):
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return torch.sqrt(torch.mean((err / scale) ** 2))


def odeint_dopri5(
    func,
    y0: torch.Tensor,
    t0: float,
    t1: float,
    *,
    rtol: float = 1e-2,
    atol: float = 1e-6,
    dt0: float = 1e-4,
    max_steps: int = 64,
    safety: float = 0.9,
    factor_min: float = 0.2,
    factor_max: float = 10.0,
):
    """Integrate dy/dt = func(t, y) from t0 to t1 >= t0.

    Returns ``(y1, dt_final, accepted, rejected)`` — the controller's final
    proposed dt supports warm-restart chaining across intervals exactly
    like our ``solve_at``.
    """
    t = torch.as_tensor(t0, dtype=y0.dtype, device=y0.device)
    t1 = torch.as_tensor(t1, dtype=y0.dtype, device=y0.device)
    dt = torch.as_tensor(dt0, dtype=y0.dtype, device=y0.device)
    y = y0.clone()
    f = func(t, y)  # FSAL cache
    accepted = rejected = 0

    while float(t1 - t) > 0.0 and accepted + rejected < max_steps:
        remaining = torch.clamp(t1 - t, min=0.0)
        clamped = bool(dt >= remaining)
        dt_c = remaining if clamped else dt

        ks = [f]
        for i in range(1, 7):
            yi = y.clone()
            for a, k in zip(_A[i], ks):
                if a != 0.0:
                    yi = yi + dt_c * a * k
            ks.append(func(t + _C[i] * dt_c, yi))
        y1 = y.clone()
        for b, k in zip(_B_SOL, ks):
            if b != 0.0:
                y1 = y1 + dt_c * b * k
        err = torch.zeros_like(y)
        for b, k in zip(_B_ERR, ks):
            if b != 0.0:
                err = err + dt_c * b * k

        ratio = _rms_ratio(err, y, y1, rtol, atol)
        accept = bool(ratio <= 1.0)
        safe = torch.clamp(ratio, min=1e-10)
        factor = torch.clamp(
            safety * safe ** (-1.0 / ORDER), factor_min, factor_max
        )
        dt = torch.clamp(dt_c * factor,
                         min=torch.finfo(y0.dtype).tiny)
        if accept:
            t = t1.clone() if clamped else t + dt_c
            y = y1
            f = ks[-1]  # FSAL
            accepted += 1
        else:
            rejected += 1
    return y, dt, accepted, rejected
