"""The port's solver core and kernel K1 (fused_ode_solve) against the JAX
package: the vmapped XLA while-solve and the Pallas kernel in interpret
mode. Same numpy inputs into both; step counts must be equal per row."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.ops.mlp import apply_mlp as jax_apply_mlp
from ode_vio_tpu.ops.pallas_kernels import fused_ode_solve as jax_fused_ode_solve
from ode_vio_tpu.ops.solvers import SolverOptions as JaxSolverOptions
from ode_vio_tpu.ops.solvers import solve_ivp_dt as jax_solve_ivp_dt
from ode_vio_tpu.ops.solvers.tableaus import TABLEAUS as JAX_TABLEAUS
from ode_vio_tpu_torch.ops import cuda_kernels
from ode_vio_tpu_torch.ops.mlp import apply_mlp
from ode_vio_tpu_torch.ops.solvers import SolverOptions, get_tableau, solve_ivp_dt

from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the tolerance tests/test_pallas.py holds the Pallas kernel to against the
# XLA solver: f32 with sums taken in another order (XLA also contracts
# a + b*c into one FMA, PyTorch on the CPU does not). The intervals are
# frame intervals (0.08-0.13 s, as KITTI's 10 Hz frames): over intervals
# ten times longer, a 1-ulp difference in the stage sums shifts the
# controller's step proposals (the error estimate is a difference of
# nearly equal stage sums), the solutions differ at the solver's own
# tolerance, and an accept decision near ratio 1 can flip.
RTOL, ATOL = 2e-5, 2e-6
KW = dict(rtol=1e-3, atol=1e-6, max_steps=64)


def make_problem(n=5, feat=8, hidden=16, layers=2, seed=0, zero_rows=(1,)):
    rng = np.random.default_rng(seed)
    sizes = [feat] + [hidden] * layers + [feat]
    params = [
        {"w": (rng.standard_normal((sizes[i + 1], sizes[i])) *
               np.sqrt(2.0 / sizes[i])).astype(np.float32),
         "b": (0.1 * rng.standard_normal(sizes[i + 1])).astype(np.float32)}
        for i in range(len(sizes) - 1)
    ]
    y0 = (0.5 * rng.standard_normal((n, feat))).astype(np.float32)
    t0 = rng.uniform(0.0, 0.3, n).astype(np.float32)
    t1 = (t0 + rng.uniform(0.08, 0.13, n)).astype(np.float32)
    for r in zero_rows:
        if r < n:
            t1[r] = t0[r]  # zero-length interval: nothing to do
    dt0 = rng.uniform(1e-3, 5e-2, n).astype(np.float32)  # per-row warm start
    return params, y0, t0, t1, dt0


def torch_layers(params):
    return [(torch.from_numpy(p["w"]), torch.from_numpy(p["b"])) for p in params]


def run_jax_vmap(params, y0, t0, t1, dt0, activation):
    opts = JaxSolverOptions(method="dopri5", unroll_mode="while", **KW)
    fn = lambda t, y: jax_apply_mlp(params, y, activation)  # noqa: E731
    y, dt, st = jax.vmap(
        lambda y, a, b, d: jax_solve_ivp_dt(fn, y, a, b, opts, d)
    )(jnp.asarray(y0), jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(dt0))
    return tuple(np.asarray(x) for x in (y, dt, st.accepted, st.rejected, st.incomplete))


def run_port_core(params, y0, t0, t1, dt0, activation):
    layers = torch_layers(params)
    field = lambda t, y: apply_mlp(layers, y, activation)  # noqa: E731
    y, dt, st = solve_ivp_dt(field, torch.from_numpy(y0), torch.from_numpy(t0),
                             torch.from_numpy(t1), SolverOptions(**KW),
                             torch.from_numpy(dt0))
    return tuple(x.numpy() for x in (y, dt, st.accepted, st.rejected, st.incomplete))


def assert_same(port, ref):
    """y and the per-row counts. The final step proposal is not compared:
    it is the noisy error estimate's image (see the note on RTOL)."""
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL, atol=ATOL)
    for k in (2, 3, 4):  # accepted, rejected, incomplete
        np.testing.assert_array_equal(port[k], ref[k])


@pytest.mark.parametrize("name", sorted(JAX_TABLEAUS))
def test_tableau_registry_matches(name):
    assert dataclasses.asdict(get_tableau(name)) == dataclasses.asdict(JAX_TABLEAUS[name])


CASES = [("tanh", 5, 0), ("softplus", 5, 1), ("tanh", 3, 2), ("softplus", 3, 3)]


@pytest.mark.parametrize("activation,n,seed", CASES)
def test_solver_core_matches_jax_vmap(activation, n, seed):
    prob = make_problem(n=n, seed=seed)
    assert_same(run_port_core(*prob, activation), run_jax_vmap(*prob, activation))


@pytest.mark.parametrize("activation,n,seed", CASES)
def test_kernel_wrapper_matches_pallas_interpret(activation, n, seed):
    """K1's wrapper on CPU tensors (its plain version) against the Pallas
    kernel run in interpret mode, ragged N=3 included (the TPU kernel pads
    rows to 8; the port needs no padding)."""
    params, y0, t0, t1, dt0 = make_problem(n=n, seed=seed)
    ref = jax_fused_ode_solve(
        params, jnp.asarray(y0), jnp.asarray(t0), jnp.asarray(t1),
        activation=activation, dt0=jnp.asarray(dt0), interpret=True, **KW)
    out = cuda_kernels.fused_ode_solve(
        torch_layers(params), torch.from_numpy(y0), torch.from_numpy(t0),
        torch.from_numpy(t1), activation=activation,
        dt0=torch.from_numpy(dt0), **KW)
    assert_same(tuple(x.numpy() for x in out), tuple(np.asarray(x) for x in ref))


def test_zero_length_rows_untouched():
    params, y0, t0, _, dt0 = make_problem(n=4)
    out = cuda_kernels.fused_ode_solve(
        torch_layers(params), torch.from_numpy(y0), torch.from_numpy(t0),
        torch.from_numpy(t0), dt0=torch.from_numpy(dt0), **KW)
    np.testing.assert_array_equal(out[0].numpy(), y0)
    np.testing.assert_array_equal(out[1].numpy(), dt0)
    assert int(out[2].sum()) == int(out[3].sum()) == int(out[4].sum()) == 0


def test_starved_budget_marks_incomplete():
    """max_steps=1 from dt0=1e-4 cannot cover a 0.08+ s interval."""
    params, y0, t0, t1, _ = make_problem(n=5, zero_rows=())
    kw = dict(KW, max_steps=1)
    port = cuda_kernels.fused_ode_solve(
        torch_layers(params), torch.from_numpy(y0), torch.from_numpy(t0),
        torch.from_numpy(t1), dt0=1e-4, **kw)
    ref = jax_fused_ode_solve(params, jnp.asarray(y0), jnp.asarray(t0),
                              jnp.asarray(t1), dt0=1e-4, interpret=True, **kw)
    np.testing.assert_array_equal(port[4].numpy(), np.ones(5, np.int32))
    assert_same(tuple(x.numpy() for x in port), tuple(np.asarray(x) for x in ref))


def test_cpu_wrapper_takes_plain_version_and_equals_solver_core():
    """On a CPU tensor the wrapper runs the plain version, launches and
    builds nothing, and gives what the solver core gives, bit for bit."""
    params, y0, t0, t1, dt0 = make_problem(n=5, seed=4)
    layers = torch_layers(params)
    args = (torch.from_numpy(y0), torch.from_numpy(t0), torch.from_numpy(t1))
    before = cuda_kernels.fused_ode_solve.launches
    out = cuda_kernels.fused_ode_solve(layers, *args, activation="softplus",
                                       dt0=torch.from_numpy(dt0), **KW)
    assert cuda_kernels.fused_ode_solve.launches == before
    assert cuda_kernels._libs is None  # nothing was built
    plain = cuda_kernels.fused_ode_solve_plain(
        layers, *args, torch.from_numpy(dt0), activation="softplus",
        method="dopri5", safety=0.9, factor_min=0.2, factor_max=10.0, **KW)
    core = run_port_core(params, y0, t0, t1, dt0, "softplus")
    for a, b, c in zip(out, plain, core):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c)


def test_wrapper_rejects_bad_inputs():
    params, y0, t0, t1, _ = make_problem(n=3)
    with pytest.raises(ValueError):
        cuda_kernels.fused_ode_solve(torch_layers(params), torch.from_numpy(y0),
                                     torch.from_numpy(t0), torch.from_numpy(t1),
                                     method="rk4")
    with pytest.raises(ValueError):
        cuda_kernels.fused_ode_solve(torch_layers(params), torch.from_numpy(y0),
                                     torch.from_numpy(t0), torch.from_numpy(t1),
                                     activation="gelu")
