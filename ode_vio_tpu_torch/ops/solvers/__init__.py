"""The solver core: adaptive, fixed-step and Adams solves over rows, in
inference, bounded training and continuous-adjoint modes."""

from ode_vio_tpu_torch.ops.solvers.odeint import (  # noqa: F401
    SolverOptions,
    Stats,
    solve_at,
    solve_ivp,
    solve_ivp_adjoint,
    solve_ivp_batched_dt,
    solve_ivp_dt,
)
from ode_vio_tpu_torch.ops.solvers.tableaus import TABLEAUS, ButcherTableau, get_tableau  # noqa: F401
