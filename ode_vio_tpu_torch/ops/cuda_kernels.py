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

Kernel K3, :func:`fused_dropout`, replaces
``ode_vio_tpu/ops/pallas_kernels.py::pallas_dropout``: dropout whose keep
mask comes from a keyed Philox4x32-10 generator inside the kernel, so the
backward pass (:class:`FusedDropout`) regenerates it and no mask is ever
stored. Its source is ``ode_vio_tpu_torch/csrc/fused_dropout.cu``.

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
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("fused_ode_solve", "fused_cde_solve", "fused_dropout")}
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
    u32 = ctypes.c_uint32
    fn = libs["fused_dropout"].fused_dropout_launch
    fn.argtypes = [p, p, ctypes.c_longlong, i,   # x, y, n, dtype
                   u32, u32, u32, f, p]          # key low, key high, thresh, scale, stream
    fn.restype = ctypes.c_int


def reset_launch_counts() -> None:
    fused_ode_solve.launches = 0
    fused_cde_solve.launches = 0
    fused_dropout.launches = 0


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


# ---------------------------------------------------------------------------
# K3: fused dropout, Philox mask regenerated in the backward pass
# ---------------------------------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # csrc/fused_dropout.cu


def _mulhilo(m: int, a: torch.Tensor):
    """The high and low words of the 64-bit product of the 32-bit constant
    ``m`` and the 32-bit words ``a`` (held in int64), with ``a`` split into
    16-bit halves so that no partial product leaves int64."""
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter: Sequence[torch.Tensor], key: int):
    """Philox4x32-10 (Random123's constants) in int64 arithmetic: the four
    32-bit output words for the counter words ``counter`` (four int64
    tensors) under the 64-bit ``key``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key & _U32, key >> 32 & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_constants(rate: float):
    """The keep threshold on the 32-bit draws (drop iff bits < thresh) and
    the float32 scale of kept elements, as ``pallas_dropout`` sets them."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    thresh = min(int(round(rate * 4294967296.0)), 4294967295)
    return thresh, torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


def fused_dropout_plain(x: torch.Tensor, key: int, rate: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bit for bit: element i keeps
    its value times the scale, rounded once to ``x``'s type, iff word
    ``i % 4`` of Philox(counter ``i // 4``, ``key``) >= the threshold."""
    if rate == 0.0:
        return x
    thresh, scale = dropout_constants(rate)
    n = x.numel()
    q = torch.arange((n + 3) // 4, dtype=torch.int64, device=x.device)
    zero = torch.zeros_like(q)
    words = philox4x32_10((q & _U32, q >> 32, zero, zero), key)
    keep = torch.stack([w >= thresh for w in words], 1).reshape(-1)[:n].reshape(x.shape)
    return torch.where(keep, (x.float() * scale).to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                                          device=x.device))


def fused_dropout(x: torch.Tensor, key: int, rate: float) -> torch.Tensor:
    """Dropout of ``x`` at ``rate`` (in [0, 1)) with the keep mask of the
    64-bit ``key``; rate 0 returns ``x`` itself. A contiguous float32,
    bfloat16 or float16 tensor on a CUDA device runs the kernel (anything
    else there raises); a CPU tensor runs :func:`fused_dropout_plain`."""
    thresh, scale = dropout_constants(rate)
    if rate == 0.0:
        return x
    if x.device.type == "cpu":
        return fused_dropout_plain(x, key, rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dropout runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_IDS or not x.is_contiguous():
        raise ValueError(f"fused_dropout: x must be a contiguous float32, bfloat16 or "
                         f"float16 tensor, got {x.dtype} (contiguous={x.is_contiguous()})")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = build()["fused_dropout"]
    err = lib.fused_dropout_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_IDS[x.dtype], key & _U32,
        key >> 32 & _U32, thresh, scale, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_dropout kernel launch failed: CUDA error {err}")
    fused_dropout.launches += 1
    return y


fused_dropout.launches = 0


def _in_memory_order(fn, order: Sequence[int], x: torch.Tensor, key: int, rate: float):
    """``fn`` on ``x`` with its dims permuted to ``order``, where that view
    is contiguous (else on a contiguous copy of it), permuted back."""
    inverse = sorted(range(len(order)), key=order.__getitem__)
    return fn(x.permute(*order).contiguous(), key, rate).permute(*inverse)


class FusedDropout(torch.autograd.Function):
    """Dropout whose backward regenerates the forward's mask from the key:
    only the key, the rate and a dim order are saved. The mask counts the
    elements in the input's memory order (the dims from the largest stride
    to the smallest), so a dense tensor in any layout (cuDNN's
    channels-last outputs) runs without a copy; the backward puts the
    gradient in that same order. ``kernel`` False runs the plain version in
    both directions (the same bits)."""

    @staticmethod
    def forward(ctx, x, key: int, rate: float, kernel: bool):
        order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
        ctx.key, ctx.rate, ctx.kernel, ctx.order = key, rate, kernel, order
        return _in_memory_order(fused_dropout if kernel else fused_dropout_plain,
                                order, x, key, rate)

    @staticmethod
    def backward(ctx, g):
        fn = fused_dropout if ctx.kernel else fused_dropout_plain
        return _in_memory_order(fn, ctx.order, g, ctx.key, ctx.rate), None, None, None
