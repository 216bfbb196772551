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
share the adaptive loop in ``csrc/adaptive_rk.cuh``: one persistent
cooperative grid of one block per SM that holds the field's weights in
the blocks' shared memory and steps every row together under grid
barriers. The split of the field over the blocks is planned here
(:func:`ode_grid_plan`, :func:`cde_grid_plan`) and passed to the kernel as
an int array. The plan keeps every row's controller state in every
block's shared memory, so one launch takes at most :func:`max_grid_rows`
rows (778 at the flagship ODE field on an H100, 2,498 at the flagship cde
field); the wrappers split more rows into launches of at most that
many, which gives the same bits, since no row's arithmetic reads another's.

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
which adds one per kernel launch and nowhere else. While a profiler
collects, K1 also adds each launch's row evaluations (its lockstep field
evaluations, a work word, times its rows) to the counter
``ode_vio.k1.row_evals`` of ``utils/profiling.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ode_vio_tpu_torch.ops.interpolation import InterpolatedPath, cdeint_path
from ode_vio_tpu_torch.ops.mlp import Layer, apply_cde_func, apply_mlp
from ode_vio_tpu_torch.ops.solvers.odeint import SolverOptions, solve_ivp_dt
from ode_vio_tpu_torch.ops.solvers.tableaus import ButcherTableau, get_tableau
from ode_vio_tpu_torch.utils import profiling

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
_MAX_LAYERS = 8
_ACT_IDS = {"tanh": 0, "relu": 1, "leaky_relu": 2, "softplus": 3}
# the plan's header words, in the order of csrc/adaptive_rk.cuh's PlanWord
PLAN_WORDS = ("n_blocks", "n_rows", "resident", "row_chunk", "smem_bytes", "own_max",
              "off_x", "off_g", "off_dx", "off_state", "off_rows",
              *(f"off_w{l}" for l in range(_MAX_LAYERS)), "scr_xin", "scr_partial",
              *(f"scr_h{l}" for l in range(_MAX_LAYERS)), "scr_floats")
_ROW_WORDS = 13  # per-row controller arrays (csrc/adaptive_rk.cuh::Rows)
_STATIC_SMEM = 1_024  # left for the kernels' static shared memory

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
    grid = [p, i, i, p, p, p]   # plan, n_blocks, smem bytes, scratch, work, stream
    fn = libs["fused_ode_solve"].fused_ode_solve_launch
    fn.argtypes = [
        p, p, p, p,             # y0, t0, t1, dt0
        *field_and_tableau,
        p, p, p, p, p,          # y1, dt, accepted, rejected, incomplete
        i, *grid,               # n_rows
    ]
    fn.restype = ctypes.c_int
    fn = libs["fused_cde_solve"].fused_cde_solve_launch
    fn.argtypes = [
        p, p, p, p, p, p, f,    # z0, path_ts, path_b, path_c, path_d, eval_ts, dt0
        *field_and_tableau,
        p, p, p, p, p, p,       # zs, dt, accepted, rejected, incomplete, step log
        i, i, i, i, *grid,      # n_rows, C, T, E
    ]
    fn.restype = ctypes.c_int
    u32 = ctypes.c_uint32
    fn = libs["fused_dropout"].fused_dropout_launch
    fn.argtypes = [p, p, ctypes.c_longlong, i,   # x, y, n, dtype
                   u32, u32, u32, f, p]          # key low, key high, thresh, scale, stream
    fn.restype = ctypes.c_int


# ---------------------------------------------------------------------------
# The grid plan of K1 and K2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridPlan:
    """How K1 or K2 splits a field over a persistent grid of ``n_blocks``
    blocks for ``n_rows`` rows. ``starts[l]`` holds the ``n_blocks + 1``
    starts of each block's contiguous range of layer l's outputs, counted
    in units of ``unit_rows[l]`` rows (1, or C for the cde field's last
    layer: whole h). The block that owns a unit of the last layer owns that
    state component of every row. ``resident``: the blocks hold their rows
    of every layer in shared memory; else they read them from global
    memory. ``row_chunk``: rows of a layer's input staged in shared memory
    at a time. ``smem`` and ``scratch`` give each region's offset in
    floats (shared memory per block; the global scratch buffer of
    ``scratch_floats``)."""

    n_blocks: int
    n_rows: int
    starts: Tuple[Tuple[int, ...], ...]
    unit_rows: Tuple[int, ...]
    resident: bool
    row_chunk: int
    smem_bytes: int
    resident_bytes: int
    own_max: int
    smem: Dict[str, int]
    scratch: Dict[str, int]
    scratch_floats: int

    def words(self) -> List[int]:
        """The int array the kernel reads: the header (``PLAN_WORDS``),
        then every layer's starts."""
        head = {"n_blocks": self.n_blocks, "n_rows": self.n_rows,
                "resident": int(self.resident), "row_chunk": self.row_chunk,
                "smem_bytes": self.smem_bytes, "own_max": self.own_max,
                **self.smem, **self.scratch, "scr_floats": self.scratch_floats}
        return [head.get(w, 0) for w in PLAN_WORDS] + [s for st in self.starts for s in st]


def _balanced(n: int, g: int) -> Tuple[int, ...]:
    """The starts of ``g`` contiguous ranges over ``n`` items, their sizes
    within one of each other."""
    return tuple(b * n // g for b in range(g + 1))


def _r4(x: int) -> int:  # floats to a 16-byte multiple
    return (x + 3) // 4 * 4


def _layout(sizes: Dict[str, int]) -> Tuple[Dict[str, int], int]:
    """Consecutive 16-byte aligned regions of ``sizes`` floats: their
    offsets and the total."""
    offsets, at = {}, 0
    for name, n in sizes.items():
        offsets[name] = at
        at += _r4(n)
    return offsets, at


def _grid_plan(dims: Sequence[int], n_rows: int, n_blocks: int, stages: int,
               channels: int, smem_limit: int) -> GridPlan:
    dims = tuple(int(d) for d in dims)
    L = len(dims) - 1
    if n_blocks < 1 or n_rows < 1:
        raise ValueError(f"a grid plan needs blocks and rows, got {n_blocks} blocks "
                         f"and {n_rows} rows")
    if not 1 <= L <= _MAX_LAYERS or min(dims) < 1:
        raise ValueError(f"the field's widths {dims} are not 1 to {_MAX_LAYERS} layers")
    if not 2 <= stages <= _MAX_STAGES:
        raise ValueError(f"{stages} stages: the kernels take 2 to {_MAX_STAGES}")
    unit = (1,) * (L - 1) + (channels or 1,)
    if channels and dims[-1] != dims[0] * channels:
        raise ValueError(f"the cde field's last layer has {dims[-1]} outputs, not "
                         f"H*C = {dims[0]}*{channels}")
    starts = tuple(_balanced(dims[l + 1] // unit[l], n_blocks) for l in range(L))
    own = [max(s[b + 1] - s[b] for b in range(n_blocks)) for s in starts]
    N, C = n_rows, channels
    weights = {f"off_w{l}": own[l] * unit[l] * dims[l] for l in range(L)}
    budget = (smem_limit - _STATIC_SMEM) // 4

    def layout(resident: bool, chunk: int):
        return _layout({**(weights if resident else {}),
                        "off_x": chunk * max(dims[:-1]),
                        "off_g": chunk * own[-1] * C, "off_dx": chunk * C,
                        "off_state": (3 + stages) * N * own[-1], "off_rows": _ROW_WORDS * N})

    if layout(False, 1)[1] > budget:
        raise ValueError(f"no grid plan: {N} rows of the field {dims} do not fit in "
                         f"{n_blocks} blocks' shared memory even with the weights in "
                         f"global memory: split them (max_grid_rows)")
    resident = layout(True, 1)[1] <= budget
    chunk = next(c for c in range(N, 0, -1) if layout(resident, c)[1] <= budget)
    smem, total = layout(resident, chunk)
    scratch, scr_floats = _layout({"scr_xin": 2 * N * dims[0], "scr_partial": n_blocks * N,
                                   **{f"scr_h{l}": N * dims[l + 1] for l in range(L - 1)}})
    return GridPlan(n_blocks=n_blocks, n_rows=N, starts=starts, unit_rows=unit,
                    resident=resident, row_chunk=chunk, smem_bytes=4 * total,
                    resident_bytes=4 * sum(_r4(v) for v in weights.values()) if resident else 0,
                    own_max=own[-1], smem=smem, scratch=scratch, scratch_floats=scr_floats)


def ode_grid_plan(dims: Sequence[int], n_rows: int, n_blocks: int, smem_limit: int,
                  stages: int = 7) -> GridPlan:
    """K1's plan for the field ``dims`` (F -> ... -> F) over ``n_blocks``
    blocks of ``smem_limit`` bytes of shared memory: every layer split by
    output neurons, the weights resident in shared memory where the blocks
    hold them and a chunk of one row, else streamed from global memory.
    Raises ValueError for more than :func:`max_grid_rows` rows."""
    return _grid_plan(dims, n_rows, n_blocks, stages, 0, smem_limit)


def cde_grid_plan(dims: Sequence[int], channels: int, n_rows: int, n_blocks: int,
                  smem_limit: int, stages: int = 7) -> GridPlan:
    """K2's plan for the field ``dims`` (H -> ... -> H*C, C = ``channels``):
    the hidden layers split by output neurons, the last layer by h, the C
    rows of one h always in one block; resident or streamed as for
    :func:`ode_grid_plan`."""
    if channels < 1:
        raise ValueError(f"a cde field needs channels, got {channels}")
    return _grid_plan(dims, n_rows, n_blocks, stages, channels, smem_limit)


@functools.lru_cache(maxsize=256)
def max_grid_rows(dims: Tuple[int, ...], n_blocks: int, smem_limit: int, stages: int = 7,
                  channels: int = 0) -> int:
    """The most rows one launch of K1 (``channels`` 0) or K2 takes on the
    field ``dims``: every block keeps each row's controller state and its
    state components, so the rows' share of shared memory grows with them.
    0 where not even one row fits."""
    def fits(n: int) -> bool:
        try:
            _grid_plan(dims, n, n_blocks, stages, channels, smem_limit)
        except ValueError:
            return False
        return True

    lo, hi = 0, 1  # fits(lo), and hi is past the limit once fits(hi) fails
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def in_row_pieces(fn, n: int, max_rows: int, row_args: Sequence[Optional[torch.Tensor]]):
    """``fn(*pieces)`` on the fewest consecutive pieces of at most
    ``max_rows`` of the ``n`` rows of each of ``row_args`` (None passes
    through), as even as they go, its outputs concatenated along rows; one
    call where ``n <= max_rows``."""
    if max_rows < 1:
        raise ValueError("no row fits in one launch")
    if n <= max_rows:
        return fn(*row_args)
    size = -(-n // -(-n // max_rows))
    outs = [fn(*(None if a is None else a[r0:r0 + size] for a in row_args))
            for r0 in range(0, n, size)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


@functools.lru_cache(maxsize=None)
def _device_grid(device: torch.device) -> Tuple[int, int]:
    """One block per SM: the SM count and the shared memory one block can
    use (the opt-in limit), as the device reports them."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


@functools.lru_cache(maxsize=64)
def _plan_on(device: torch.device, dims: Tuple[int, ...], channels: int, n_rows: int,
             stages: int) -> Tuple[GridPlan, torch.Tensor]:
    """The plan for one block per SM of ``device`` and its words on the
    device, made once per shape."""
    sms, smem_limit = _device_grid(device)
    plan = _grid_plan(dims, n_rows, sms, stages, channels, smem_limit)
    return plan, torch.tensor(plan.words(), dtype=torch.int32, device=device)


def _grid_launch_args(device, dims, channels: int, n_rows: int, stages: int):
    """The plan, and the launch arguments after the kernel's own: the plan's
    words, the grid, the shared-memory bytes, a scratch buffer, and the work
    words (the barrier's counter, then the launch's barriers, lockstep
    steps and field evaluations, which the kernel writes)."""
    plan, words = _plan_on(device, tuple(dims), channels, n_rows, stages)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=device)
    work = torch.zeros(4, dtype=torch.int32, device=device)
    return plan, work, [words.data_ptr(), plan.n_blocks, plan.smem_bytes, scratch.data_ptr(),
                        work.data_ptr(), torch.cuda.current_stream(device).cuda_stream], scratch


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
    controller, and the field's widths. The host arrays stay alive through
    the ``ctypes.cast`` results that reference them."""
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
    return args, dims


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
    ``max_steps`` before ``t1``. On a CUDA device, more rows than one launch
    takes (:func:`max_grid_rows`, 778 at the flagship field on an H100)
    run as several launches, each counted in ``.launches``.
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
    field, dims = _field_and_tableau(
        name, layers, feat, device, tab, activation, rtol, atol, safety,
        factor_min, factor_max, max_steps)
    if dims[-1] != feat:
        raise ValueError(f"the field maps {feat} features to {dims[-1]}")

    lib = build()[name]

    def launch(y0, t0, t1, dt0):
        n = y0.shape[0]
        plan, work, grid, _scratch = _grid_launch_args(device, dims, 0, n, tab.num_stages)
        y1 = torch.empty_like(y0)
        dt_out, acc, rej, inc = _outputs(n, device)
        err = lib.fused_ode_solve_launch(
            y0.data_ptr(), t0.data_ptr(), t1.data_ptr(), dt0.data_ptr(), *field,
            y1.data_ptr(), dt_out.data_ptr(), acc.data_ptr(), rej.data_ptr(),
            inc.data_ptr(), n, *grid,
        )
        if err != 0:
            raise RuntimeError(f"fused_ode_solve kernel launch failed: CUDA error {err}")
        fused_ode_solve.launches += 1
        fused_ode_solve.last = (plan, work)
        if profiling.collecting():
            # the launch's lockstep field evaluations times its rows: the
            # row evaluations it did, needed or not (read after the launch)
            profiling.count("ode_vio.k1.row_evals", work[3], n)
        return y1, dt_out, acc, rej, inc

    rows = max_grid_rows(tuple(dims), *_device_grid(device), tab.num_stages)
    return in_row_pieces(launch, n, rows, (y0, t0, t1, dt0))


fused_ode_solve.launches = 0
fused_ode_solve.last = None  # (plan, work words) of the latest launch


# ---------------------------------------------------------------------------
# K2: fused multi-segment CDE solve
# ---------------------------------------------------------------------------

def fused_cde_solve_plain(layers: Sequence[Layer], z0, path_ts, path_b, path_c,
                          path_d, eval_ts, *, activation: str, method: str,
                          rtol: float, atol: float, dt0: float, max_steps: int,
                          safety: float, factor_min: float, factor_max: float,
                          log_steps: bool = False):
    """The kernel's function in plain PyTorch: the port's CDE solve
    (``ops/interpolation.py::cdeint_path``) on the same field, path and
    controller settings, with the kernel's step log where ``log_steps``."""
    opts = SolverOptions(method=method, rtol=rtol, atol=atol, dt0=dt0,
                         max_steps=max_steps, safety=safety,
                         factor_min=factor_min, factor_max=factor_max)
    H, C = z0.shape[1], path_b.shape[-1]
    zeros = torch.zeros_like(path_b)  # a (unused by the derivative); c, d of a linear path
    path = InterpolatedPath(path_ts, zeros, path_b,
                            zeros if path_c is None else path_c,
                            zeros if path_d is None else path_d)
    log = [] if log_steps else None
    zs, dt, stats = cdeint_path(lambda z: apply_cde_func(layers, z, activation, H, C),
                                z0, path, eval_ts, opts, log=log)
    if not log_steps:
        return (zs, dt, *stats)
    steps = z0.new_zeros(z0.shape[0], eval_ts.shape[1], max_steps, 2)
    for j, attempts in enumerate(log):
        if attempts:
            steps[:, j, :len(attempts)] = torch.stack(attempts, 1)
    return (zs, dt, *stats, steps)


def fused_cde_solve(layers: Sequence[Layer], z0: torch.Tensor, path_ts: torch.Tensor,
                    path_b: torch.Tensor, path_c: Optional[torch.Tensor],
                    path_d: Optional[torch.Tensor], eval_ts: torch.Tensor, *,
                    activation: str = "tanh", method: str = "dopri5",
                    rtol: float = 1e-4, atol: float = 1e-6, dt0: float = 1e-4,
                    max_steps: int = 256, safety: float = 0.9,
                    factor_min: float = 0.2, factor_max: float = 10.0,
                    log_steps: bool = False):
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
    (``incomplete``: segments that ran out of budget). With ``log_steps``,
    also the step log ``(N, E, max_steps, 2)``: each row's attempts in each
    segment in order, ``(t, h)`` with ``h`` the step taken from ``t``,
    negated where it was rejected, ``(0, 0)`` past the row's last attempt,
    so that a replay of the accepted steps redoes the solve. On a CUDA
    device, more rows than one launch takes (:func:`max_grid_rows`, 2,498
    at the flagship cde field on an H100) run as several launches, each
    counted.
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
                                     eval_ts, log_steps=log_steps, **kw)
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
    field, dims = _field_and_tableau(
        name, layers, H, device, tab, activation, rtol, atol, safety,
        factor_min, factor_max, max_steps)
    if dims[-1] != H * C:
        raise ValueError(f"the field's last layer has {dims[-1]} outputs, "
                         f"not H*C = {H}*{C}")

    lib = build()[name]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731

    def launch(z0, path_ts, path_b, path_c, path_d, eval_ts):
        n = z0.shape[0]
        plan, work, grid, _scratch = _grid_launch_args(device, dims, C, n, tab.num_stages)
        zs = torch.empty(n, E, H, dtype=torch.float32, device=device)
        dt_out, acc, rej, inc = _outputs(n, device)
        steps = (torch.zeros(n, E, max_steps, 2, dtype=torch.float32, device=device)
                 if log_steps else None)
        err = lib.fused_cde_solve_launch(
            z0.data_ptr(), path_ts.data_ptr(), path_b.data_ptr(), ptr(path_c),
            ptr(path_d), eval_ts.data_ptr(), float(dt0), *field,
            zs.data_ptr(), dt_out.data_ptr(), acc.data_ptr(), rej.data_ptr(),
            inc.data_ptr(), ptr(steps), n, C, T, E, *grid,
        )
        if err != 0:
            raise RuntimeError(f"fused_cde_solve kernel launch failed: CUDA error {err}")
        fused_cde_solve.launches += 1
        fused_cde_solve.last = (plan, work)
        if profiling.collecting():
            # as K1's: the launch's lockstep field evaluations times its rows
            profiling.count("ode_vio.k2.row_evals", work[3], n)
        return (zs, dt_out, acc, rej, inc) + ((steps,) if log_steps else ())

    rows = max_grid_rows(tuple(dims), *_device_grid(device), tab.num_stages, C)
    return in_row_pieces(launch, n, rows, (z0, path_ts, path_b, path_c, path_d, eval_ts))


fused_cde_solve.launches = 0
fused_cde_solve.last = None  # (plan, work words) of the latest launch


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
