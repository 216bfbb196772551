"""The port's hand-written CUDA kernels: build, binding, launch counts
and plain PyTorch versions.

Kernel K1, :func:`fused_ode_solve`, replaces the TPU kernel
``ode_vio_tpu/ops/pallas_kernels.py::fused_ode_solve``: one frame
interval's whole adaptive ODE solve of the ODE-RNN core, for all rows at
once. Its source is ``ode_vio_tpu_torch/csrc/fused_ode_solve.cu``.

Build: at first use, ``csrc/fused_ode_solve.cu`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, in
``ode_vio_tpu_torch/_build/`` (listed in ``.gitignore``). The library's
file name carries the hash of its source, so an edited source is rebuilt.
It is loaded with ``ctypes``; pointers and the stream pass as
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
from typing import Optional, Sequence

import torch

from ode_vio_tpu_torch.ops.mlp import Layer, apply_mlp
from ode_vio_tpu_torch.ops.solvers.odeint import SolverOptions, solve_ivp_dt
from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "fused_ode_solve.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must match csrc/fused_ode_solve.cu
_MAX_STAGES = 8
_ACT_IDS = {"tanh": 0, "relu": 1, "leaky_relu": 2, "softplus": 3}

_lib: Optional[ctypes.CDLL] = None
build_output = ""  # nvcc/ptxas output of this process's build, if it built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build() -> ctypes.CDLL:
    """Compile the kernel library if it is missing or stale, and load it."""
    global _lib, build_output
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        build_output = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} (exit "
                               f"{proc.returncode}):\n{build_output}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.fused_ode_solve_launch
    fn.argtypes = [
        p, p, p, p,             # y0, t0, t1, dt0
        p, p, p, i, i,          # weights, biases, dims (host), n_layers, act
        p, p, p, i, i, f,       # tableau a, b_sol, b_err (host), stages, fsal, expo
        f, f, f, f, f, i,       # rtol, atol, safety, factor_min, factor_max, max_steps
        p, p, p, p, p,          # y1, dt, accepted, rejected, incomplete
        i, p,                   # n_rows, stream
    ]
    fn.restype = ctypes.c_int


def reset_launch_counts() -> None:
    fused_ode_solve.launches = 0


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


def _tableau_arrays(tab: ButcherTableau):
    a = (ctypes.c_float * (_MAX_STAGES * _MAX_STAGES))()
    for i, row in enumerate(tab.a):
        for j, c in enumerate(row):
            a[i * _MAX_STAGES + j] = c
    b_sol = (ctypes.c_float * _MAX_STAGES)(*tab.b_sol)
    b_err = (ctypes.c_float * _MAX_STAGES)(*tab.b_err)
    return a, b_sol, b_err


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"fused_ode_solve: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
        )


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
    if not tab.adaptive_capable:
        raise ValueError(f"method '{method}' has no error estimate")
    if activation not in _ACT_IDS:
        raise ValueError(f"activation '{activation}' not supported; "
                         f"choose from {sorted(_ACT_IDS)}")
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

    f32 = torch.float32
    _check("y0", y0, (n, feat), f32, device)
    for name, x in (("t0", t0), ("t1", t1), ("dt0", dt0)):
        _check(name, x, (n,), f32, device)
    dims = [feat]
    for k, (w, b) in enumerate(layers):
        _check(f"layers[{k}].w", w, (w.shape[0], dims[-1]), f32, device)
        _check(f"layers[{k}].b", b, (w.shape[0],), f32, device)
        dims.append(w.shape[0])
    if dims[-1] != feat:
        raise ValueError(f"the field maps {feat} features to {dims[-1]}")

    lib = build()
    y1 = torch.empty_like(y0)
    dt_out = torch.empty(n, dtype=f32, device=device)
    acc, rej, inc = (torch.empty(n, dtype=torch.int32, device=device)
                     for _ in range(3))
    vp = ctypes.c_void_p
    weights = (vp * len(layers))(*(w.data_ptr() for w, _ in layers))
    biases = (vp * len(layers))(*(b.data_ptr() for _, b in layers))
    c_dims = (ctypes.c_int * len(dims))(*dims)
    a, b_sol, b_err = _tableau_arrays(tab)
    err = lib.fused_ode_solve_launch(
        y0.data_ptr(), t0.data_ptr(), t1.data_ptr(), dt0.data_ptr(),
        ctypes.cast(weights, vp), ctypes.cast(biases, vp),
        ctypes.cast(c_dims, vp), len(layers), _ACT_IDS[activation],
        ctypes.cast(a, vp), ctypes.cast(b_sol, vp), ctypes.cast(b_err, vp),
        tab.num_stages, int(tab.fsal), -1.0 / tab.order,
        rtol, atol, safety, factor_min, factor_max, max_steps,
        y1.data_ptr(), dt_out.data_ptr(), acc.data_ptr(), rej.data_ptr(),
        inc.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_ode_solve kernel launch failed: CUDA error {err}")
    fused_ode_solve.launches += 1
    return y1, dt_out, acc, rej, inc


fused_ode_solve.launches = 0
