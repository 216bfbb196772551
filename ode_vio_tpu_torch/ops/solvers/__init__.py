"""Adaptive ODE solver core (inference and bounded training modes)."""

from ode_vio_tpu_torch.ops.solvers.odeint import (  # noqa: F401
    SolverOptions,
    Stats,
    solve_ivp_batched_dt,
    solve_ivp_dt,
)
from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau  # noqa: F401
