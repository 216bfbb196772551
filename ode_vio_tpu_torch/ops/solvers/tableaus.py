"""Explicit Runge-Kutta Butcher tableau registry (the port's copy of
``ode_vio_tpu/ops/solvers/tableaus.py``, coefficient for coefficient).

The tableaus are plain data consumed by the generic stepper in
:mod:`ode_vio_tpu_torch.ops.solvers.odeint` and passed, as float32
arrays, to the fused solve kernel (``ops/cuda_kernels.py``).

All coefficients are standard published values (Dormand & Prince 1980,
Tsitouras 2011, Bogacki & Shampine 1989, Fehlberg 1969).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ButcherTableau:
    """An explicit (embedded) Runge-Kutta method.

    ``a`` holds the strictly-lower-triangular stage coefficients (row ``i``
    has ``i`` entries), ``b_sol`` the solution weights, ``b_err`` the
    difference ``b_sol - b_hat`` against the embedded lower-order solution
    (None for methods without an error estimate), ``c`` the stage times.
    ``order`` is the primary order (step-size exponent is ``-1/order``,
    matching torchdiffeq/torchode). ``fsal`` marks First-Same-As-Last
    methods whose final stage derivative can seed the next step.
    """

    name: str
    a: Tuple[Tuple[float, ...], ...]
    b_sol: Tuple[float, ...]
    b_err: Optional[Tuple[float, ...]]
    c: Tuple[float, ...]
    order: int
    fsal: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.b_sol)

    @property
    def adaptive_capable(self) -> bool:
        return self.b_err is not None


EULER = ButcherTableau(
    name="euler",
    a=((),),
    b_sol=(1.0,),
    b_err=None,
    c=(0.0,),
    order=1,
)

MIDPOINT = ButcherTableau(
    name="midpoint",
    a=((), (0.5,)),
    b_sol=(0.0, 1.0),
    b_err=(-1.0, 1.0),  # embedded euler
    c=(0.0, 0.5),
    order=2,
)

HEUN = ButcherTableau(
    name="heun",
    a=((), (1.0,)),
    b_sol=(0.5, 0.5),
    b_err=(-0.5, 0.5),  # embedded euler
    c=(0.0, 1.0),
    order=2,
)

RK4 = ButcherTableau(
    name="rk4",
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b_sol=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
    b_err=None,
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
)

# Bogacki-Shampine 3(2), FSAL.
BOSH3 = ButcherTableau(
    name="bosh3",
    a=((), (0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9)),
    b_sol=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    c=(0.0, 0.5, 0.75, 1.0),
    order=3,
    fsal=True,
)

# Fehlberg 2(1) (RKF12): 3 stages, 2nd order with embedded 1st-order
# estimate — torchdiffeq's 'fehlberg2' method string.
FEHLBERG2 = ButcherTableau(
    name="fehlberg2",
    a=((), (0.5,), (1 / 256, 255 / 256)),
    b_sol=(1 / 512, 255 / 256, 1 / 512),
    b_err=(1 / 512 - 1 / 256, 0.0, 1 / 512),  # embedded (1/256, 255/256, 0)
    c=(0.0, 0.5, 1.0),
    order=2,
)

# Dormand-Prince 5(4), FSAL — the reference's default solver family.
DOPRI5 = ButcherTableau(
    name="dopri5",
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b_sol=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(
        35 / 384 - 5179 / 57600,
        0.0,
        500 / 1113 - 7571 / 16695,
        125 / 192 - 393 / 640,
        -2187 / 6784 + 92097 / 339200,
        11 / 84 - 187 / 2100,
        -1 / 40,
    ),
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    order=5,
    fsal=True,
)

# Tsitouras 5(4), FSAL (Tsitouras 2011, free parameters as in the paper).
TSIT5 = ButcherTableau(
    name="tsit5",
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (
            5.325864828439257,
            -11.748883564062828,
            7.4955393428898365,
            -0.09249506636175525,
        ),
        (
            5.86145544294642,
            -12.92096931784711,
            8.159367898576159,
            -0.071584973281401,
            -0.028269050394068383,
        ),
        (
            0.09646076681806523,
            0.01,
            0.4798896504144996,
            1.379008574103742,
            -3.290069515436081,
            2.324710524099774,
        ),
    ),
    b_sol=(
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ),
    b_err=(
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ),
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    order=5,
    fsal=True,
)

TABLEAUS: dict[str, ButcherTableau] = {
    t.name: t
    for t in (EULER, MIDPOINT, HEUN, RK4, BOSH3, FEHLBERG2, DOPRI5, TSIT5)
}
# torchdiffeq / reference flag aliases
TABLEAUS["runge_kutta"] = RK4
# torchdiffeq's 'adaptive_heun' IS Heun with the embedded-Euler error
# estimate — our HEUN tableau already carries it.
TABLEAUS["adaptive_heun"] = HEUN


def get_tableau(name: str) -> ButcherTableau:
    try:
        return TABLEAUS[name]
    except KeyError:
        raise ValueError(
            f"Solver '{name}' not supported; choose from {sorted(TABLEAUS)}"
        ) from None
