"""The port's hand-written CUDA kernels: build, binding, launch counts
and plain PyTorch versions.

Kernel K1, :func:`fused_ode_solve`, replaces the TPU kernel
``ode_vio_tpu/ops/pallas_kernels.py::fused_ode_solve``: one frame
interval's whole adaptive ODE solve of the ODE-RNN core, for all rows at
once. Its source is ``ode_vio_tpu_torch/csrc/fused_ode_solve.cu``.

Kernel K2, :func:`fused_cde_solve`, replaces
``ode_vio_tpu/ops/pallas_kernels.py::fused_cde_solve``: the whole
multi-segment neural-CDE solve of the CDE and RDE cores, for all rows at
once. Its source is ``ode_vio_tpu_torch/csrc/fused_cde_solve.cu``. Both
share the adaptive loop in ``csrc/adaptive_rk.cuh``.

Build: at first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, in
``ode_vio_tpu_torch/_build/`` (listed in ``.gitignore``), all ``nvcc``
runs started together. A library's file name carries the hash of its
source and of the shared header, so an edited source is rebuilt. The
libraries are loaded with ``ctypes``; pointers and the stream pass as
``c_void_p``.

Dispatch: a wrapper given CPU tensors runs the plain PyTorch version in
this module; given CUDA tensors it launches the kernel or raises. Each
wrapper counts its launches in a plain integer attribute (``.launches``),
which adds one per kernel launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from ode_vio_tpu_torch.ops.interpolation import InterpolatedPath, cdeint_path
from ode_vio_tpu_torch.ops.mlp import Layer, apply_cde_func, apply_mlp
from ode_vio_tpu_torch.ops.solvers.odeint import SolverOptions, solve_ivp_dt
from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SOURCES = {name: CSRC / f"{name}.cu" for name in ("fused_ode_solve", "fused_cde_solve")}
HEADER = CSRC / "adaptive_rk.cuh"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must match csrc/adaptive_rk.cuh
_MAX_STAGES = 8
_ACT_IDS = {"tanh": 0, "relu": 1, "leaky_relu": 2, "softplus": 3}

_libs: Optional[Dict[str, ctypes.CDLL]] = None
build_output: Dict[str, str] = {}  # nvcc/ptxas output of this process's builds, by kernel


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _library(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + HEADER.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build() -> Dict[str, ctypes.CDLL]:
    """Compile the kernel libraries that are missing or stale, one ``nvcc``
    per source, all started together, and load them all."""
    global _libs
    if _libs is not None:
        return _libs
    outs = {name: _library(src) for name, src in SOURCES.items()}
    running = {}
    for name, out in outs.items():
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            running[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in running.items():
        build_output[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} (exit "
                          f"{proc.returncode}):\n{build_output[name]}")
        else:
            os.replace(tmp, outs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {name: ctypes.CDLL(str(out)) for name, out in outs.items()}
    _bind(libs)
    _libs = libs
    return libs


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    field_and_tableau = [
        p, p, p, i, i,          # weights, biases, dims (host), n_layers, act
        p, p, p, p, i, i, f,    # tableau a, b_sol, b_err, c (host), stages, fsal, expo
        f, f, f, f, f, i,       # rtol, atol, safety, factor_min, factor_max, max_steps
    ]
    fn = libs["fused_ode_solve"].fused_ode_solve_launch
    fn.argtypes = [
        p, p, p, p,             # y0, t0, t1, dt0
        *field_and_tableau,
        p, p, p, p, p,          # y1, dt, accepted, rejected, incomplete
        i, p,                   # n_rows, stream
    ]
    fn.restype = ctypes.c_int
    fn = libs["fused_cde_solve"].fused_cde_solve_launch
    fn.argtypes = [
        p, p, p, p, p, p, f,    # z0, path_ts, path_b, path_c, path_d, eval_ts, dt0
        *field_and_tableau,
        p, p, p, p, p,          # zs, dt, accepted, rejected, incomplete
        i, i, i, i, p,          # n_rows, C, T, E, stream
    ]
    fn.restype = ctypes.c_int


def reset_launch_counts() -> None:
    fused_ode_solve.launches = 0
    fused_cde_solve.launches = 0


def _check_method(tab: ButcherTableau, method: str, activation: str) -> None:
    if not tab.adaptive_capable:
        raise ValueError(f"method '{method}' has no error estimate")
    if activation not in _ACT_IDS:
        raise ValueError(f"activation '{activation}' not supported; "
                         f"choose from {sorted(_ACT_IDS)}")


def _check(kernel: str, name: str, x: torch.Tensor, shape, device) -> None:
    dtype = torch.float32
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
        )


def _field_and_tableau(kernel: str, layers: Sequence[Layer], in_dim: int, device,
                       tab: ButcherTableau, activation: str, rtol: float,
                       atol: float, safety: float, factor_min: float,
                       factor_max: float, max_steps: int):
    """Checks the field's layers (``in_dim`` -> ... -> out) and returns the
    launch arguments that describe the field, the tableau and the
    controller, and the field's output width. The host arrays stay alive
    through the ``ctypes.cast`` results that reference them."""
    dims = [in_dim]
    for k, (w, b) in enumerate(layers):
        _check(kernel, f"layers[{k}].w", w, (w.shape[0], dims[-1]), device)
        _check(kernel, f"layers[{k}].b", b, (w.shape[0],), device)
        dims.append(w.shape[0])
    vp, c_float = ctypes.c_void_p, ctypes.c_float
    a = (c_float * (_MAX_STAGES * _MAX_STAGES))()
    for i, row in enumerate(tab.a):
        for j, c in enumerate(row):
            a[i * _MAX_STAGES + j] = c
    host = lambda x: ctypes.cast(x, vp)  # noqa: E731
    args = [host((vp * len(layers))(*(w.data_ptr() for w, _ in layers))),
            host((vp * len(layers))(*(b.data_ptr() for _, b in layers))),
            host((ctypes.c_int * len(dims))(*dims)), len(layers), _ACT_IDS[activation],
            host(a), host((c_float * _MAX_STAGES)(*tab.b_sol)),
            host((c_float * _MAX_STAGES)(*tab.b_err)), host((c_float * _MAX_STAGES)(*tab.c)),
            tab.num_stages, int(tab.fsal), -1.0 / tab.order,
            rtol, atol, safety, factor_min, factor_max, max_steps]
    return args, dims[-1]


def _outputs(n: int, device):
    """dt_final (f32) and the accepted, rejected, incomplete counts (int32)."""
    return (torch.empty(n, dtype=torch.float32, device=device),
            *(torch.empty(n, dtype=torch.int32, device=device) for _ in range(3)))


# ---------------------------------------------------------------------------
# K1: fused adaptive ODE solve
# ---------------------------------------------------------------------------

def fused_ode_solve_plain(layers: Sequence[Layer], y0, t0, t1, dt0, *,
                          activation: str, method: str, rtol: float,
                          atol: float, max_steps: int, safety: float,
                          factor_min: float, factor_max: float):
    """The kernel's function in plain PyTorch: the port's solver core on
    the same field and controller settings."""
    opts = SolverOptions(method=method, rtol=rtol, atol=atol, max_steps=max_steps,
                         safety=safety, factor_min=factor_min, factor_max=factor_max)
    y, dt, stats = solve_ivp_dt(lambda t, y: apply_mlp(layers, y, activation),
                                y0, t0, t1, opts, dt0)
    return (y, dt, *stats)


def fused_ode_solve(layers: Sequence[Layer], y0: torch.Tensor,
                    t0: torch.Tensor, t1: torch.Tensor, *,
                    activation: str = "tanh", method: str = "dopri5",
                    rtol: float = 1e-2, atol: float = 1e-6, dt0=1e-4,
                    max_steps: int = 64, safety: float = 0.9,
                    factor_min: float = 0.2, factor_max: float = 10.0):
    """Batched adaptive integration of ``dy/dt = MLP(y)`` (``layers`` as
    ``(w (out, in), b (out,))`` pairs, ``activation`` on the hidden layers,
    tanh on the last) from ``t0`` to ``t1 >= t0``, each row with its own
    step size. ``dt0`` is a scalar or a per-row (N,) warm start.

    Returns ``(y1 (N, F), dt_final (N,), accepted, rejected, incomplete)``,
    the counts int32 (N,); ``incomplete[i] = 1`` where row i ran out of
    ``max_steps`` before ``t1``.
    """
    tab = get_tableau(method)
    _check_method(tab, method, activation)
    if y0.dim() != 2:
        raise ValueError(f"y0 must be (N, F), got {tuple(y0.shape)}")
    n, feat = y0.shape
    device = y0.device
    dt0 = torch.as_tensor(dt0, dtype=torch.float32, device=device)
    if dt0.dim() == 0:
        dt0 = dt0.expand(n).contiguous()
    kw = dict(activation=activation, method=method, rtol=rtol, atol=atol,
              max_steps=max_steps, safety=safety, factor_min=factor_min,
              factor_max=factor_max)
    if device.type == "cpu":
        return fused_ode_solve_plain(layers, y0, t0, t1, dt0, **kw)
    if device.type != "cuda":
        raise ValueError(f"fused_ode_solve runs on cuda or cpu, not {device}")
    if n == 0:
        raise ValueError("fused_ode_solve needs at least one row")

    name = "fused_ode_solve"
    _check(name, "y0", y0, (n, feat), device)
    for arg, x in (("t0", t0), ("t1", t1), ("dt0", dt0)):
        _check(name, arg, x, (n,), device)
    field, out_dim = _field_and_tableau(
        name, layers, feat, device, tab, activation, rtol, atol, safety,
        factor_min, factor_max, max_steps)
    if out_dim != feat:
        raise ValueError(f"the field maps {feat} features to {out_dim}")

    lib = build()[name]
    y1 = torch.empty_like(y0)
    dt_out, acc, rej, inc = _outputs(n, device)
    err = lib.fused_ode_solve_launch(
        y0.data_ptr(), t0.data_ptr(), t1.data_ptr(), dt0.data_ptr(), *field,
        y1.data_ptr(), dt_out.data_ptr(), acc.data_ptr(), rej.data_ptr(),
        inc.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_ode_solve kernel launch failed: CUDA error {err}")
    fused_ode_solve.launches += 1
    return y1, dt_out, acc, rej, inc


fused_ode_solve.launches = 0


# ---------------------------------------------------------------------------
# K2: fused multi-segment CDE solve
# ---------------------------------------------------------------------------

def fused_cde_solve_plain(layers: Sequence[Layer], z0, path_ts, path_b, path_c,
                          path_d, eval_ts, *, activation: str, method: str,
                          rtol: float, atol: float, dt0: float, max_steps: int,
                          safety: float, factor_min: float, factor_max: float):
    """The kernel's function in plain PyTorch: the port's CDE solve
    (``ops/interpolation.py::cdeint_path``) on the same field, path and
    controller settings."""
    opts = SolverOptions(method=method, rtol=rtol, atol=atol, dt0=dt0,
                         max_steps=max_steps, safety=safety,
                         factor_min=factor_min, factor_max=factor_max)
    H, C = z0.shape[1], path_b.shape[-1]
    zeros = torch.zeros_like(path_b)  # a (unused by the derivative); c, d of a linear path
    path = InterpolatedPath(path_ts, zeros, path_b,
                            zeros if path_c is None else path_c,
                            zeros if path_d is None else path_d)
    zs, dt, stats = cdeint_path(lambda z: apply_cde_func(layers, z, activation, H, C),
                                z0, path, eval_ts, opts)
    return (zs, dt, *stats)


def fused_cde_solve(layers: Sequence[Layer], z0: torch.Tensor, path_ts: torch.Tensor,
                    path_b: torch.Tensor, path_c: Optional[torch.Tensor],
                    path_d: Optional[torch.Tensor], eval_ts: torch.Tensor, *,
                    activation: str = "tanh", method: str = "dopri5",
                    rtol: float = 1e-4, atol: float = 1e-6, dt0: float = 1e-4,
                    max_steps: int = 256, safety: float = 0.9,
                    factor_min: float = 0.2, factor_max: float = 10.0):
    """Batched neural-CDE solve ``dz = g(z) dX(t)``, ``g(z) =
    tanh(MLP(z)).reshape(H, C)`` (``layers`` H -> ... -> H*C, h-major), for
    each row of ``z0`` (N, H) on its own path, through ``[path_ts[:, 0]] +
    eval_ts``. The path: knots ``path_ts`` (N, T) and per-segment
    derivative coefficients ``path_b``, ``path_c``, ``path_d`` (N, T-1, C);
    ``path_c``/``path_d`` None for a linear path. Each segment is a fresh
    adaptive solve with its own ``max_steps``; the step size starts at the
    scalar ``dt0`` and carries across segments.

    Returns ``(zs (N, E, H), dt_final (N,), accepted, rejected,
    incomplete)``, the counts int32 (N,) summed over segments
    (``incomplete``: segments that ran out of budget).
    """
    tab = get_tableau(method)
    _check_method(tab, method, activation)
    if z0.dim() != 2 or path_ts.dim() != 2 or path_b.dim() != 3 or eval_ts.dim() != 2:
        raise ValueError("fused_cde_solve takes z0 (N, H), path_ts (N, T), "
                         "path_b (N, T-1, C) and eval_ts (N, E)")
    if (path_c is None) != (path_d is None):
        raise ValueError("path_c and path_d are both given (cubic) or both None (linear)")
    n, H = z0.shape
    T, E, C = path_ts.shape[1], eval_ts.shape[1], path_b.shape[2]
    device = z0.device
    kw = dict(activation=activation, method=method, rtol=rtol, atol=atol, dt0=dt0,
              max_steps=max_steps, safety=safety, factor_min=factor_min,
              factor_max=factor_max)
    if device.type == "cpu":
        return fused_cde_solve_plain(layers, z0, path_ts, path_b, path_c, path_d,
                                     eval_ts, **kw)
    if device.type != "cuda":
        raise ValueError(f"fused_cde_solve runs on cuda or cpu, not {device}")
    if n == 0 or T < 2 or E < 1 or len(layers) < 2:
        raise ValueError(f"fused_cde_solve needs rows, 2+ knots, 1+ evaluation "
                         f"times and 2+ layers; got N={n}, T={T}, E={E}, "
                         f"{len(layers)} layers")

    name = "fused_cde_solve"
    _check(name, "z0", z0, (n, H), device)
    _check(name, "path_ts", path_ts, (n, T), device)
    _check(name, "eval_ts", eval_ts, (n, E), device)
    coefs = [path_b] + ([] if path_c is None else [path_c, path_d])
    for arg, x in zip(("path_b", "path_c", "path_d"), coefs):
        _check(name, arg, x, (n, T - 1, C), device)
    field, out_dim = _field_and_tableau(
        name, layers, H, device, tab, activation, rtol, atol, safety,
        factor_min, factor_max, max_steps)
    if out_dim != H * C:
        raise ValueError(f"the field's last layer has {out_dim} outputs, "
                         f"not H*C = {H}*{C}")

    lib = build()[name]
    zs = torch.empty(n, E, H, dtype=torch.float32, device=device)
    dt_out, acc, rej, inc = _outputs(n, device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.fused_cde_solve_launch(
        z0.data_ptr(), path_ts.data_ptr(), path_b.data_ptr(), ptr(path_c),
        ptr(path_d), eval_ts.data_ptr(), float(dt0), *field,
        zs.data_ptr(), dt_out.data_ptr(), acc.data_ptr(), rej.data_ptr(),
        inc.data_ptr(), n, C, T, E, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_cde_solve kernel launch failed: CUDA error {err}")
    fused_cde_solve.launches += 1
    return zs, dt_out, acc, rej, inc


fused_cde_solve.launches = 0
