"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each, any failure ends the run with a non-zero exit:
  env     the card, its power limit; TF32 off for matmuls and convs
  build   nvcc builds ode_vio_tpu_torch/csrc/fused_ode_solve.cu,
          fused_cde_solve.cu and fused_dropout.cu (sm_90a), the nvcc runs
          started together
  kernel  K1 fused_ode_solve against its plain PyTorch version at the
          flagship field (softplus 768->1024->1024->768, dopri5, rtol 1e-2,
          atol 1e-6, max_steps 64): N = 3*4 rows, ragged N = 5, 1 row, 96
          rows (32 sessions), 800 rows (more than one launch takes: the
          wrapper splits them into two launches), zero-length rows, per-row
          dt0, cases that force rejected steps and exhaust max_steps, and a
          field of twice the widths, too wide for the blocks' shared memory
          (the streamed path); y1, dt_final and the per-row counts compared. Each launch's grid
          (one block per SM, no cluster), resident bytes per block, barriers,
          lockstep steps and field evaluations are printed; times with CUDA
          events, and the time per barrier
  slice   the flagship DeepVIO (seeded init) behind
          StreamingEngine(max_sessions=4, fold_bn=True): sessions opening
          at different windows, one idle for a window; K1 must launch once
          per frame interval (10 per step)
  core    the same windows through use_kernels=False (the solver core);
          poses must agree
  kernel_cde  K2 fused_cde_solve against its plain PyTorch version at the
          flagship cde field (tanh 128->128->128->128->16512, dopri5):
          linear and cubic paths, repeated leading knots, the history
          path's own shapes (64 knots with 54 and 24 collapsed; the
          11-knot advance, collapsed and full), evaluation times off the
          knots (the rde field, C 45), a ragged row count, 1 and 32 rows,
          forced rejections, a starved budget. Each case takes the first seeded
          draw whose step counts rounding does not decide (the plain
          version in float64 and with z0 moved by 2^-21 take the same
          steps); per-row counts must be equal, the case's branch reached,
          zs within 4x the rounding's reach; the kernel's and the plain
          float32 version's distances to the float64 run are printed. The
          1-row case's row must keep its bits run to run and inside a
          4-row launch. Then the main path's input
          (its shape and solver settings, whose step counts rounding
          decides, so zs are not compared there) is timed with CUDA events
          next to the plain version
  slice_cde    the flagship configuration with the cde pose core (seeded
          init) behind StreamingEngine(max_sessions=4, fold_bn=True) on the
          same schedule; K2 must launch once per step, K1 never
  history_cde  the same in cde_streaming_mode="history": K2 launches once
          on the engine's first step, twice (advance, re-integration) after
  slice_rde    the rde pose core, carry mode: K2 once per step
  core_cde     the schedule's windows with images and IMU x0.1, served
          through K2 and through use_kernels=False (no K2 launch); poses
          must agree within 4x how far rounding alone moves them there
          (the pose core in float32 vs float64)
  eval_data  a synthetic KITTI tree written by the port's own writer
          (data/synthetic.py) at KITTI's raw image size 376x1241: sequences
          05, 07 and 10 of 111 frames (11 windows) each, every one over
          100 m; the port's C++ decoder built (native true/false, build
          seconds, the build error if any) and its decode rate at
          376x1241 -> 256x512 with 4 threads. Without a decoder (native, or
          PIL where the build fails) the run ends here
  eval_stream  the flagship ode-rnn (seed 0) through make_infer_fn(fold_bn=
          True) and KittiEvaluator at eval frame dropout 0 and 0.3, batched
          (3 lanes) and sequential: K1 10 launches a window step, none with
          use_kernels=False; per-frame poses of batched vs sequential and
          of the kernel vs use_kernels=False within 1e-3; metrics finite.
          Prints t_rel / r_rel / t_rmse / r_rmse a sequence, wall seconds,
          frames/s, the decode-wait share, truncated solves, one batched
          stream's device time under torch.profiler, and batched vs
          sequential with float32 encoders (printed, not bounded)
  eval_cli  cli.test on the flagship model saved as a reference-layout .pth
          (--pretrain), --batch_runs --run_times 2 --eval_data_dropout 0.3
          (6 lanes): summary.txt holds three sequences with finite means,
          the pose dumps exist, K1 10 launches a window step; then
          --model_type cde on one sequence: K2 once a window, K1 never,
          finite metrics
  serve_cli  cli.serve on one sequence, then on the three as sessions: both
          JSON reports printed as they come, the JAX package's report keys,
          p50 under 1,000 ms, K1 10 launches a step, and 10 a forward of
          the warm-up (one cold forward an encoder bucket, one carried)
  train_cli  cli.train on the flagship's train configuration (B=16, frozen
          encoder, frame dropout 0.3 +- 0.1, eval dropout 0.3, K3 on the
          trunk) over the tree's sequences 05 and 07, evaluated on 10 after
          every epoch: two epochs in one run, then epoch 0 and a run resumed
          from its checkpoints directory for epoch 1. K3 9 launches a step,
          K1 10 a window step of the evaluation, from the loader's batches
          and the evaluation's partitions; the split run's epoch_001 (model,
          optimizer, step, generator) equal to the continuous run's bit for
          bit, and restored into a fresh state on the card bit for bit.
          Prints each epoch's wall seconds, step p50, trained frame pairs/s,
          eval frames/s, losses, t_rel, and the peak memory
  train_cli_cde  one epoch of cli.train --model_type cde the same way: K2
          once a window of the evaluation and never in a train step, K1
          never, finite losses, truncated solves by step; then two rde
          train steps at B=16 (make_train_step): 9 K3 launches each, no K2
  train_tbptt  cli.train --model_type cde --tbptt_chain 8 for one epoch on
          two 200-frame training sequences it writes into the tree at
          256x512 (20 chain chunks: one group of 16 lanes, 8 steps),
          evaluated on sequence 10: K3 9 a step, K2 once a window of the
          evaluation and never in a step, K1 never; no carry at the chain's
          start and one on every other step; each step's peak memory, the
          chain's last no higher than its second's (+1 %). Prints the
          chunks, the cold and carried step p50 and the epoch's report
  train_carry  cli.train --carry_exposure: one cde epoch at 0.2 (K2 only in
          the evaluation), and the ode-rnn split run at 0.5 whose epoch_001
          must equal the continuous run's bit for bit (the exposure's draws
          come from the seed and the epoch); then 3 fresh and 3 carried
          make_train_step steps each of ode-rnn and rde at B=16 (9 K3
          launches a step either way, no K1, no K2), their p50 compared
  cores   the rnn, gru, cfc and ltc pose cores at the flagship's widths
          (768-d fused feature, 3 RNN layers, rnn_hidden_dim 1024, 256x512
          images): StreamingEngine(max_sessions=4, fold_bn=True) over 4
          windows with a closed session and a late joiner in its lane, in
          bf16 (timed) and float32 (every lane within 1e-5 of its session's
          own forward, session 0's first two windows within 1e-4 of the
          same model on the CPU); cli.test on one sequence; 3 train steps
          at B=16 (9 K3 launches each). K1 and K2 never launch
  solver_modes  the rest of the solver core at the flagship's widths on the
          eval tree: one cli.train epoch of ode-rnn and of cde with --adjoint
          and the same epoch without it (K3 9 a step, K1 / K2 only in the
          evaluation; step p50, epoch wall, each step's peak memory, the
          backward solves the adjoint truncated); one make_train_step batch
          at B=16 (float32 encoders) through the adjoint and the bounded
          solve, the pose core's field gradients compared (cosine >= 0.99
          for ode-rnn) and the memory a pose-core forward keeps for its
          backward; cli.test on sequence 05 with --ode_fixed_step and with
          --model_type cde --cde_solver implicit_adams (no K1, no K2), the
          first two windows card against CPU within 1e-4 (float32 encoders,
          cde on windows x0.1) and one window served by StreamingEngine
  kernel_dropout  K3 fused_dropout against its plain PyTorch version, bit
          for bit (torch.equal), forward and backward (the autograd
          Function with the kernel and with the plain version): the nine
          trunk activations at B=2 in bf16 at the trunk's rates, an odd-size
          float32 tensor at rates 0.2, 0.5 and 0.999, a bf16 tensor not
          aligned to a 4-element group; the keep fraction within 4 sigma.
          Then times with CUDA events at B=16 (the largest activation and
          the nine of one step) beside the plain version and F.dropout
  train   the flagship train config (frozen image encoder in train mode,
          trunk dropout through K3) for 4 steps at B=16 on seeded batches
          with frame intervals of 0.08-0.13 s: finite losses, 9 K3 and 0 K1
          launches per step, frozen image weights bitwise unchanged, its
          BatchNorm statistics and the trained params moved
  train_encoder  the same with the image encoder trained (freeze_encoder
          False): 18 K3 launches per step (forward and backward), image
          weights moved
  train_frozen_eval  the flagship train config with frozen_encoder_eval:
          the image encoder's folded inference graph, 0 K3 launches, its
          weights and statistics unchanged
  train_plain  the first train step twice from one init and generator
          seed, with K3 and with use_kernels=False (0 K3 launches), cuDNN
          deterministic: the losses within 1e-6 relative
  profile_train  one train step under torch.profiler: device busy and
          idle share, K3's and the convolutions' share, the solver's
          early-exit checks (host syncs)
  encoders  the int8 and s2d encoders at the flagship's width (4 lanes of
          10 frame pairs, 256x512, bf16, seed-0 weights): each of the nine
          int8 trunk convs on its own input, the card's int32 sums (int8
          im2col + torch._int_mm) equal to the plain version's (a float64
          conv) bit for bit, timed with CUDA events beside the GEMM alone
          and cuDNN's bf16 conv of the layer, with its bound; the int8
          features against the float ones (correlation > 0.99); the trunk
          int8 against bf16 as eval runs them; cli.test on sequence 05,
          float and --encoder_int8 (K1 10 a window, the int8 GEMM 9 a
          window); with encoder_s2d the trunk within 2e-2 of the direct
          one's largest feature, conv1 and conv2 timed both ways, one train
          step at B=16 (finite loss, K3 9 launches)
  edges   train_cli's checkpoints directory through cli.export to .pth and
          .npz (its model state without num_batches_tracked, bit for bit);
          cli.test on sequence 05 from the .pth and from the directory,
          poses bit for bit equal; cli.parity --torch_protocol of the .pth
          on the three sequences (the report); one cli.train epoch with
          --profile_dir, its trace holding K3's 36 kernel events of steps
          1-4 and the convolutions'; a NaN in one IMU sample raising
          FloatingPointError under --debug_nans and not without it;
          analyse_flops of the flagship forward, device_memory_stats
  mesh    data parallelism on the one card (parallel/mesh.py): train_mesh,
          two ranks sharing cuda:0 over gloo (launch), the flagship's train
          configuration at B=16 global (8 a rank) for 3 steps: K3 9 a step
          on each rank, the ranks' states (model, optimizer, step,
          generator) bit for bit equal after every step, their dropout keys
          different; step p50 and peak memory per rank, the gradient's
          all-reduce alone over gloo with its bytes; one float32 step
          without dropout or weight decay against one process's at B=16
          (loss and trained tensors within 1e-4 where the gradient clears
          rounding). train_cli_mesh: cli.train --mesh_data 2 on the eval
          tree for two epochs, then resumed from its epoch 0: epoch_001 bit
          for bit; K3 9 a step a rank, K1 10 a window step of rank 0's
          evaluation. eval_mesh: eval_runs of the three sequences twice (6
          lanes) and StreamingEngine with 4 sessions over two replicas on
          the card, in bf16 and float32, each eval lane against the
          unsplit run and each session against an engine of its block's
          lanes within 1e-3 / 1e-5, K1 10 a window step a replica; the cde model
          on 05 twice split over the replicas, K2 once a window a replica
  entry   ode_vio_tpu_torch/entry.py::entry(): the flagship forward (seed-0
          weights) on its batch-1 example, K1 10 launches, finite poses
          within 1e-3 of the same weights through make_infer_fn with
          use_kernels=False; both timed with CUDA events
  dryrun_multichip  entry.py::dryrun_multichip(4): JAX's tiny training
          configuration on a (2, 2) mesh of four ranks sharing the card over
          gloo, the weights param_sharding_rules names split over the model
          axis (each rank stores half of them, their Adam moments and
          accumulation mean), one two-step accumulation cycle with K3 18 a
          step on every rank; JAX's ok line and each rank's stored bytes.
          Then the same without dropout against one process unsplit: loss,
          grad_norm and the gathered trained tensors within 1e-4, the stored
          bytes the unsplit process's less half of the split ones
  learn   the odometric convergence recipe (experiments/convergence.py, JAX's
          tests/test_convergence.py) on the card: eval RMSE after training
          below half the untrained model's; K3 18 a step, K1 3 an eval window
  seconds  each phase's wall time
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import torch.nn.functional as F

from ode_vio_tpu_torch.cli import test as cli_test_module
from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.cli.export import main as export_main
from ode_vio_tpu_torch.cli.parity import main as parity_main
from ode_vio_tpu_torch.cli.serve import main as serve_main
from ode_vio_tpu_torch.cli.test import main as cli_test_main
from ode_vio_tpu_torch.cli.train import main as train_main
from ode_vio_tpu_torch.config import flagship_config
from ode_vio_tpu_torch.data import native_loader
from ode_vio_tpu_torch.data.evaluation import METRICS, EvalPartition, KittiEvaluator, eval_runs
from ode_vio_tpu_torch.data.kitti import load_sequence
from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
from ode_vio_tpu_torch.models import encoders
from ode_vio_tpu_torch.models.convert import load_reference_file
from ode_vio_tpu_torch.models.deepvio import DeepVIO, analyse_flops, create_model
from ode_vio_tpu_torch.models.encoders import TRUNK, TRUNK_NAMES, ImageEncoder
from ode_vio_tpu_torch.models.fold import fold_batchnorm, fold_batchnorm_into_bias
from ode_vio_tpu_torch.ops import cuda_kernels
from ode_vio_tpu_torch.ops.interpolation import make_path
from ode_vio_tpu_torch.ops.mlp import cde_func_sizes, init_mlp, ode_func_sizes
from ode_vio_tpu_torch.ops.solvers import get_tableau, odeint
from ode_vio_tpu_torch.serving import StreamingEngine
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
from ode_vio_tpu_torch.training.loop import (create_train_state, encoder_bucket, make_infer_fn,
                                              make_train_step)
from ode_vio_tpu_torch.utils import geometry, profiling

SEED = 0
SESSIONS = 4
# core_cde serves the windows with images and IMU samples times this
# factor, where rounding alone does not move the cde poses by their size
CDE_CORE_SCALE = 0.1
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def phase(which: str, **fields) -> None:
    print(json.dumps({"phase": which, **fields}), flush=True)


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median over ``runs`` of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def env() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("env", device=name, nvidia_smi=smi, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          tf32_matmul=False, tf32_cudnn=False)
    return name


def build() -> None:
    t = time.perf_counter()
    cuda_kernels.build()
    secs = time.perf_counter() - t
    ptxas = {name: [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
             for name, out in cuda_kernels.build_output.items()}
    phase("build", seconds=round(secs, 3),
          sources=[src.name for src in cuda_kernels.SOURCES.values()], ptxas=ptxas)


def bound(evals: int, n_params: int, nbytes: int) -> dict:
    """The least time for the work: ``evals`` field evaluations at 2 flops
    per weight at the f32 CUDA-core peak, or the bytes at the HBM rate."""
    flops = evals * 2 * n_params
    b = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "flops_ms": flops / F32_FLOPS * 1e3}
    return {"evals": evals, "flops": flops, "bytes": nbytes, **b,
            "bound_ms": max(b.values()),
            "bound_by": "operations" if b["flops_ms"] >= b["bytes_ms"] else "bytes"}


def field_problem(n: int, zero_rows, gen: torch.Generator, dev, gain: float = 1.0,
                  width: int = 1):
    """The flagship ODE field (its weights times ``gain``, its widths times
    ``width``) and one frame interval per row."""
    m = flagship_config().model
    sizes = ode_func_sizes(width * m.f_len, width * m.ode_hidden_dim, m.ode_fn_num_layers)
    layers = [((gain * w).to(dev), (b + 0.01 * torch.randn(b.shape, generator=gen)).to(dev))
              for w, b in init_mlp(sizes, gen)]
    y0 = torch.tanh(torch.randn(n, width * m.f_len, generator=gen)).to(dev)
    t0 = (torch.rand(n, generator=gen) * 0.5).to(dev)
    t1 = t0 + (0.08 + 0.05 * torch.rand(n, generator=gen)).to(dev)
    t1[list(zero_rows)] = t0[list(zero_rows)]
    dt0 = (10 ** (-4 + 2.5 * torch.rand(n, generator=gen))).to(dev)  # warm starts
    return layers, y0, t0, t1, dt0


# (name, rows, zero-length rows, weight gain, dt0 override, solver overrides,
#  branches the case must reach, widths x). The flagship field at its own
# settings never rejects a step, so two cases steepen it (weights x3), start
# from dt0 = 0.1 and tighten rtol to force rejections; two starve the
# budget. A steeper field amplifies the summation-order differences, so the
# gain stays where y still agrees to 1e-4. 96 rows are 32 sessions' 3 RNN
# layers (the layers' inputs staged in row chunks); 800 rows are more than
# one launch takes (778 on an H100: every block keeps every row's state),
# so the wrapper makes two launches of 400 ("split"); the field at twice
# the widths (42 MB) does not fit in the blocks' shared memory and is read
# from global memory ("streamed").
KERNEL_CASES = (
    ("n12_zero_rows", 12, (3, 7), 1.0, None, {}, (), 1),
    ("n5_ragged", 5, (2,), 1.0, None, {}, (), 1),
    ("n12_rejects", 12, (), 3.0, 0.1, {"rtol": 1e-4, "atol": 1e-7}, ("rejected",), 1),
    ("n12_budget_rejects", 12, (5,), 3.0, 0.1, {"rtol": 1e-4, "atol": 1e-7, "max_steps": 3},
     ("rejected", "incomplete"), 1),
    ("n12_max_steps_1", 12, (0,), 1.0, 1e-4, {"max_steps": 1}, ("incomplete",), 1),
    ("n1", 1, (), 1.0, None, {}, (), 1),
    ("n96", 96, (4, 50), 1.0, None, {}, (), 1),
    ("n800_split", 800, (4, 500), 1.0, None, {}, ("split",), 1),
    ("wide_streamed", 12, (1,), 1.0, None, {}, ("streamed",), 2),
    ("n12_main", 12, (), 1.0, None, {}, (), 1),   # the main path's shape, timed below
)


def grid_launch(wrapper, sms: int) -> dict:
    """The grid of ``wrapper``'s latest launch and what it did: one block
    per SM, every block through every barrier (the barrier's arrival
    counter at blocks x barriers; none where no row had an interval to
    integrate)."""
    plan, work = wrapper.last
    arrivals, barriers, steps, evals = work.tolist()
    if plan.n_blocks != sms:
        raise AssertionError(f"{plan.n_blocks} blocks for {sms} SMs")
    if arrivals != barriers * plan.n_blocks:
        raise AssertionError(f"barrier arrivals {arrivals} for {barriers} barriers of "
                             f"{plan.n_blocks} blocks")
    return {"grid": [plan.n_blocks, 1, 1], "cluster": [1, 1, 1], "threads": 512,
            "resident": plan.resident, "resident_bytes_per_block": plan.resident_bytes,
            "smem_bytes_per_block": plan.smem_bytes, "row_chunk": plan.row_chunk,
            "barriers": barriers, "lockstep_steps": steps, "field_evals": evals}


def kernel_check(dev) -> dict:
    s = flagship_config().solver
    act = flagship_config().model.ode_activation_fn
    base = dict(activation=act, method=s.method, rtol=s.rtol, atol=s.atol,
                max_steps=s.max_steps, safety=s.safety, factor_min=s.factor_min,
                factor_max=s.factor_max)
    gen = torch.Generator().manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err, max_dt_rel, cases = 0.0, 0.0, {}
    for name, n, zero, gain, dt0_all, over, must_reach, width in KERNEL_CASES:
        layers, y0, t0, t1, dt0 = field_problem(n, zero, gen, dev, gain, width)
        if dt0_all is not None:
            dt0 = torch.full_like(dt0, dt0_all)
        kw = dict(base, **over)
        n0 = cuda_kernels.fused_ode_solve.launches
        out = cuda_kernels.fused_ode_solve(layers, y0, t0, t1, dt0=dt0, **kw)
        launch = grid_launch(cuda_kernels.fused_ode_solve, sms)
        launch["launches"] = cuda_kernels.fused_ode_solve.launches - n0
        if launch["resident"] == ("streamed" in must_reach):
            raise AssertionError(f"{name}: resident={launch['resident']}")
        if (launch["launches"] > 1) != ("split" in must_reach):
            raise AssertionError(f"{name}: {launch['launches']} launches for {n} rows")
        ref = cuda_kernels.fused_ode_solve_plain(layers, y0, t0, t1, dt0, **kw)
        torch.cuda.synchronize()
        # f32 dot products summed in another order than cuBLAS's
        torch.testing.assert_close(out[0], ref[0], rtol=1e-4, atol=1e-5)
        # dt_final warm-starts the next interval. Where a row ran out of
        # budget it is the controller's proposal dt * ratio**(-1/5) after a
        # full step, and the ratio carries the stage sums' rounding: 1e-3.
        # Where a row landed on t1 it comes from the landing step, whose
        # error ratio is far below 1 (1e-5 and less at the flagship's
        # settings), i.e. at the level of that rounding: not compared.
        # Zero-length rows keep their dt0 exactly.
        inc, zero_len = ref[4].bool(), t1 == t0
        torch.testing.assert_close(out[1][inc], ref[1][inc], rtol=1e-3, atol=0.0)
        if not torch.equal(out[1][zero_len], dt0[zero_len]):
            raise AssertionError(f"{name}: zero-length rows changed their dt")
        counts = {}
        for k, what in ((2, "accepted"), (3, "rejected"), (4, "incomplete")):
            if not torch.equal(out[k], ref[k]):
                raise AssertionError(f"{name}: per-row {what} differ: "
                                     f"{out[k].tolist()} vs {ref[k].tolist()}")
            counts[what] = out[k].tolist()
        for what in must_reach:
            if what in counts and sum(counts[what]) == 0:
                raise AssertionError(f"{name}: no row reached the {what} branch")
        if not torch.isfinite(out[0]).all():
            raise AssertionError(f"{name}: non-finite y1")
        max_err = max(max_err, float((out[0] - ref[0]).abs().max()))
        if inc.any():
            max_dt_rel = max(max_dt_rel, float(((out[1] - ref[1]).abs() / ref[1])[inc].max()))
        cases[name] = dict(counts if n <= 12 else {k: sum(v) for k, v in counts.items()},
                           **launch)

    # time the main path's shape: 3 layers x 4 lanes, every row active
    ms = cuda_ms(lambda: cuda_kernels.fused_ode_solve(layers, y0, t0, t1, dt0=dt0, **kw))
    launch = grid_launch(cuda_kernels.fused_ode_solve, sms)
    plain_ms = cuda_ms(lambda: cuda_kernels.fused_ode_solve_plain(
        layers, y0, t0, t1, dt0, **kw), runs=20)
    # bound: each input byte read once, each output byte written once; the
    # MLP evaluations this data needs (FSAL: 1 + 6 per step per row) at
    # 2 flops per weight per row, at the f32 CUDA-core peak
    tab = get_tableau(s.method)
    n_params = sum(w.numel() for w, _ in layers)
    steps = (out[2] + out[3]).cpu()
    evals = int((1 + (tab.num_stages - 1) * steps).sum()) if tab.fsal \
        else int((tab.num_stages * steps).sum())
    nbytes = 4 * (sum(w.numel() + b.numel() for w, b in layers) + y0.numel() * 2 + n * 3 + n * 4)
    bd = bound(evals, n_params, nbytes)
    phase("kernel", name="fused_ode_solve", cases=cases, max_abs_err=max_err,
          max_dt_final_rel_err_incomplete_rows=max_dt_rel, ms=ms, plain_ms=plain_ms,
          main=launch, us_per_barrier=1e3 * ms / launch["barriers"], **bd)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "barriers": launch["barriers"], "lockstep_steps": launch["lockstep_steps"]}


def cde_config():
    """The flagship configuration with the cde pose core, as the JAX
    package measured its cde row: cde_hidden_dim 128, 3 hidden field
    layers, tanh, linear path, the CDE solver dopri5 rtol 1e-4, atol 1e-6,
    dt0 1e-4, max_steps 256 (``Config.cde_solver_cfg``)."""
    cfg = flagship_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model_type="cde"))


def cde_problem(n: int, T: int, channels: int, gen: torch.Generator, dev, *,
                kind: str = "linear", repeat: int = 0, eval_frames: int = 0,
                features=("random", 1.0, 0.0)):
    """The flagship cde field for ``channels`` path channels (129 for cde,
    45 for rde) and one control path per row: T knots at frame intervals,
    a time channel and ``channels - 1`` feature channels. ``features``:
    ``("random", amp, _)`` draws every knot's features from N(0, amp^2)
    (the served path's kind: a new slope at every knot); ``("drift", amp,
    jitter)`` is a straight line with N(0, amp^2) slopes plus N(0,
    jitter^2) noise at the knots. ``repeat`` collapses the first knots onto
    the next one (a history buffer's unfilled prefix); ``eval_frames`` > 0
    evaluates at that many frame times over a 2-knot path (the rde shape).
    Returns the layers and the kernel's arguments after ``layers``."""
    m = cde_config().model
    H = m.cde_hidden_dim
    layers = [(w.to(dev), (b + 0.01 * torch.randn(b.shape, generator=gen)).to(dev))
              for w, b in init_mlp(cde_func_sizes(channels, H, m.cde_fn_num_layers), gen)]
    z0 = torch.tanh(torch.randn(n, H, generator=gen))
    frames = torch.cumsum(0.08 + 0.05 * torch.rand(n, max(T, eval_frames), generator=gen), 1)
    knots = frames[:, [0, -1]] if eval_frames else frames[:, :T].clone()
    kind_f, amp, jitter = features
    if kind_f == "random":
        f = amp * torch.randn(n, knots.shape[1], channels - 1, generator=gen)
    else:
        f = amp * torch.randn(n, 1, channels - 1, generator=gen) * knots[..., None] \
            + jitter * torch.randn(n, knots.shape[1], channels - 1, generator=gen)
    xs = torch.cat([knots[..., None], f], -1)
    if repeat:
        knots[:, :repeat] = knots[:, repeat:repeat + 1]
        xs[:, :repeat] = xs[:, repeat:repeat + 1]
    path = make_path(knots, xs, kind)
    cubic = kind == "cubic"
    args = [z0, path.ts, path.b, path.c if cubic else None, path.d if cubic else None,
            frames if eval_frames else knots]
    return layers, [None if a is None else a.contiguous().to(dev) for a in args]


# (name, rows, knots T, channels C, kind, repeated knots, eval frames,
#  features, dt0, solver overrides, branches the case must reach). T = E =
# 10 is a window of the carry mode (its first segment has zero length); 20
# knots with 8 collapsed stand for a history buffer's prefix. The history
# path of slice phases re-integrates its 64-slot buffer with 54, 44, 34 and
# 24 slots collapsed, and advances z0 over 11 slots, all collapsed until
# the buffer is full and none after: the history_* cases take those shapes
# (the first and last re-integration, both advances). The rde shape has a
# 2-knot compressed path evaluated at 10 frame times. At the
# main path's settings (rtol 1e-4, dt0 1e-4, a new slope at every knot)
# the step counts are decided by rounding (see not_decided_by_rounding), so
# these cases use paths and tolerances where they are not: rtol 1e-2 for
# random knots, 1e-3 for drifting paths (history_c24's 40 live segments
# with less jitter: at 0.003 rounding decided six draws of six, at 0.001
# five). Rejections come
# from the knots' slope changes (a landing stage reads the next segment's
# slope) and from a first step of 0.5; the budget case runs every segment
# out of its one step, the step growing x2 per segment.
CDE_CASES = (
    ("main", 4, 10, 129, "linear", 0, 0, ("random", 0.03, 0.0), None, {"rtol": 1e-2},
     ("rejected",)),
    ("cubic", 4, 10, 129, "cubic", 0, 0, ("drift", 0.1, 0.003), None, {"rtol": 1e-3}, ()),
    ("history_prefix", 4, 20, 129, "linear", 8, 0, ("drift", 0.1, 0.003), None,
     {"rtol": 1e-3}, ("zero_length", "rejected")),
    ("rde_off_knots", 4, 2, 45, "linear", 0, 10, ("drift", 0.1, 0.003), None,
     {"rtol": 1e-3}, ()),
    ("n5_ragged", 5, 10, 129, "linear", 0, 0, ("random", 0.03, 0.0), None, {"rtol": 1e-2},
     ()),
    ("rejects", 4, 10, 129, "linear", 0, 0, ("drift", 0.3, 0.003), 0.5, {"rtol": 1e-3},
     ("rejected",)),
    ("budget", 4, 10, 129, "linear", 0, 0, ("drift", 0.1, 0.003), None,
     {"rtol": 1e-3, "max_steps": 1, "factor_max": 2.0}, ("incomplete",)),
    ("history_c54", 4, 64, 129, "linear", 54, 0, ("drift", 0.1, 0.003), None,
     {"rtol": 1e-3}, ("zero_length", "rejected")),
    ("history_c24", 4, 64, 129, "linear", 24, 0, ("drift", 0.1, 0.0005), None,
     {"rtol": 1e-3}, ("zero_length", "rejected")),
    ("advance_collapsed", 4, 11, 129, "linear", 10, 0, ("drift", 0.1, 0.003), None,
     {"rtol": 1e-3}, ("zero_length",)),
    ("advance_full", 4, 11, 129, "linear", 0, 0, ("drift", 0.1, 0.003), None,
     {"rtol": 1e-3}, ("rejected",)),
    ("n1", 1, 10, 129, "linear", 0, 0, ("random", 0.03, 0.0), None, {"rtol": 1e-2}, ()),
    ("n32", 32, 10, 129, "linear", 0, 0, ("random", 0.03, 0.0), None, {"rtol": 1e-2},
     ("rejected",)),
)
# the main path's shape and settings (cde solver, a new N(0, 1) slope at
# every knot, ~190 accepted steps per row as in a served window): timed
MAIN_PATH_INPUT = (4, 10, 129, "linear", 0, 0, ("random", 1.0, 0.0))
MAX_DRAWS = 6  # draws per case until one is not decided by rounding


def not_decided_by_rounding(layers, args, kw, ref):
    """Whether the plain version takes the same per-row steps in float64
    and with z0 moved by 2^-21 as ``ref`` (its float32 run) does; the
    larger of those two runs' distances to ``ref``'s zs; and the float64
    run's zs. Where it does not, the controller's proposals after steps
    whose error ratio sits at the rounding's level (the ramp-up from dt0,
    landings on a knot) decide the step sequence, and two correct float32
    implementations part at the solver's tolerance."""
    f64 = [(w.double(), b.double()) for w, b in layers]
    runs = (cuda_kernels.fused_cde_solve_plain(
                f64, *[None if a is None else a.double() for a in args], **kw),
            cuda_kernels.fused_cde_solve_plain(
                layers, args[0] * (1 + 2.0 ** -21), *args[1:], **kw))
    same = all(torch.equal(r[k], ref[k]) for r in runs for k in (2, 3, 4))
    return same, max(float((r[0] - ref[0]).abs().max()) for r in runs), runs[0][0]


def cde_solver_kw() -> dict:
    s = cde_config().cde_solver_cfg
    return dict(activation=cde_config().model.cde_activation_fn, method=s.method,
                rtol=s.rtol, atol=s.atol, dt0=s.dt0, max_steps=s.max_steps, safety=s.safety,
                factor_min=s.factor_min, factor_max=s.factor_max)


def check_cde_case(case, dev, seed: int) -> dict:
    """One of CDE_CASES: the first of MAX_DRAWS draws (from ``seed``) whose
    counts are not decided by rounding, through K2 and its plain version.
    Counts equal per row, the case's branches reached, zs within 4x the
    rounding's reach (at least 1e-5), dt_final equal where every segment
    ran out of budget; a single row keeps its bits run to run and inside
    a 4-row launch. Returns the counts, the errors and the launches."""
    name, n, T, C, kind, repeat, frames, feat, dt0, over, must_reach = case
    kw = dict(cde_solver_kw(), **over, **({} if dt0 is None else {"dt0": dt0}))
    gen = torch.Generator().manual_seed(seed)
    for draw in range(MAX_DRAWS):
        layers, args = cde_problem(n, T, C, gen, dev, kind=kind, repeat=repeat,
                                   eval_frames=frames, features=feat)
        ref = cuda_kernels.fused_cde_solve_plain(layers, *args, **kw)
        well, gap, zs64 = not_decided_by_rounding(layers, args, kw, ref)
        if well:
            break
    else:
        raise AssertionError(f"{name}: every draw's step counts are decided by rounding")
    n0 = cuda_kernels.fused_cde_solve.launches
    out = cuda_kernels.fused_cde_solve(layers, *args, **kw)
    launch = grid_launch(cuda_kernels.fused_cde_solve,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    if not launch["resident"]:
        raise AssertionError(f"{name}: the cde field is not resident")
    if n == 1:
        # no row's arithmetic reads another's: the row's bits are the same
        # in another launch and as row 0 of a launch with 3 more rows
        _, more = cde_problem(3, T, C, gen, dev, kind=kind, repeat=repeat,
                              eval_frames=frames, features=feat)
        among = cuda_kernels.fused_cde_solve(
            layers, *[None if a is None else torch.cat([a, b]) for a, b in zip(args, more)], **kw)
        again = cuda_kernels.fused_cde_solve(layers, *args, **kw)
        if not all(torch.equal(o, a) and torch.equal(o, m[:1])
                   for o, a, m in zip(out, again, among)):
            raise AssertionError(f"{name}: the row's bits differ between launches")
    launches = cuda_kernels.fused_cde_solve.launches - n0
    torch.cuda.synchronize()
    counts = {}
    for k, what in ((2, "accepted"), (3, "rejected"), (4, "incomplete")):
        if not torch.equal(out[k], ref[k]):
            raise AssertionError(f"{name}: per-row {what} differ: "
                                 f"{out[k].tolist()} vs {ref[k].tolist()}")
        counts[what] = out[k].tolist() if n <= 12 else int(out[k].sum())
    z0, ts, ev = args[0], args[1], args[5]
    counts["zero_length"] = int((ev[:, 1:] == ev[:, :-1]).sum() + (ev[:, 0] == ts[:, 0]).sum())
    for what in must_reach:
        total = counts[what] if isinstance(counts[what], int) else sum(counts[what])
        if total == 0:
            raise AssertionError(f"{name}: no row reached the {what} branch")
    if repeat and not torch.equal(out[0][:, :repeat], z0[:, None].expand(-1, repeat, -1)):
        raise AssertionError(f"{name}: z moved over the collapsed knots")
    if not torch.isfinite(out[0]).all():
        raise AssertionError(f"{name}: non-finite zs")
    # zs: equal steps, but the step sizes carry the rounding that the two
    # reference runs show; 4x their distance, at least 1e-5
    err, atol = float((out[0] - ref[0]).abs().max()), max(1e-5, 4 * gap)
    if err > atol:
        raise AssertionError(f"{name}: zs differ by {err} (> {atol})")
    # dt_final: where a row's last segment ran out of budget it is a full
    # step's proposal (in the budget case every segment does: exact powers
    # of 2 times dt0); after a landing on a knot it is rounding noise
    if "max_steps" in over and not torch.equal(out[1], ref[1]):
        raise AssertionError(f"{name}: dt_final differs: {out[1].tolist()} vs {ref[1].tolist()}")
    # how far each float32 version lies from the float64 run
    to64 = {"kernel_to_f64": float((out[0].double() - zs64).abs().max()),
            "plain_to_f64": float((ref[0].double() - zs64).abs().max())}
    return dict(counts, draw=draw, max_abs_err=err, zs_atol=atol, **to64, **launch,
                launches=launches)


def kernel_cde_check(dev) -> dict:
    cases = {case[0]: check_cde_case(case, dev, SEED + i) for i, case in enumerate(CDE_CASES)}
    max_err = max(c["max_abs_err"] for c in cases.values())
    base = cde_solver_kw()
    gen = torch.Generator().manual_seed(SEED)
    # the main path's input, timed. Rounding decides its step counts (the
    # two versions' are printed), and z on it then differs by about its own
    # size, so zs are not compared here: the cases above hold K2 at this
    # shape (main, n5_ragged, rejects, budget) and at the history path's.
    layers, args = cde_problem(*MAIN_PATH_INPUT[:3], gen, dev, kind=MAIN_PATH_INPUT[3],
                               features=MAIN_PATH_INPUT[6])
    out = cuda_kernels.fused_cde_solve(layers, *args, **base)
    launch = grid_launch(cuda_kernels.fused_cde_solve,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    ref = cuda_kernels.fused_cde_solve_plain(layers, *args, **base)
    if not torch.isfinite(out[0]).all():
        raise AssertionError("main path input: non-finite zs")
    ms = cuda_ms(lambda: cuda_kernels.fused_cde_solve(layers, *args, **base), runs=10, warmup=1)
    plain_ms = cuda_ms(lambda: cuda_kernels.fused_cde_solve_plain(layers, *args, **base),
                       runs=5, warmup=1)
    bd = cde_bound(layers, args, out)
    main_path = dict(accepted=out[2].tolist(), accepted_plain=ref[2].tolist(),
                     rejected=out[3].tolist(), rejected_plain=ref[3].tolist(),
                     zs_finite=True)
    phase("kernel_cde", name="fused_cde_solve", cases=cases, max_abs_err=max_err,
          main_path_input=main_path, ms=ms, plain_ms=plain_ms, main=launch,
          us_per_barrier=1e3 * ms / launch["barriers"], **bd)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "barriers": launch["barriers"], "lockstep_steps": launch["lockstep_steps"]}


def cde_bound(layers, args, out) -> dict:
    """K2's bound on this data: the field evaluations the counts need (FSAL
    dopri5: 1 per segment that takes a step, 6 per step); the bytes of
    the weights, the path and z in, zs and the counts out."""
    tab = get_tableau(cde_config().cde_solver_cfg.method)
    z0, ts, _, _, _, ev = args
    t_start = torch.cat([ts[:, :1], ev[:, :-1]], 1)
    busy = int(((ev - t_start) > 0).sum())
    steps = int((out[2] + out[3]).sum())
    evals = busy + (tab.num_stages - 1) * steps
    n_params = sum(w.numel() for w, _ in layers)
    nbytes = 4 * (sum(w.numel() + b.numel() for w, b in layers)
                  + sum(a.numel() for a in args if a is not None)
                  + out[0].numel() + 4 * z0.shape[0])
    return bound(evals, n_params, nbytes)


def make_windows(cfg, gen: np.random.Generator, n_windows: int, sessions: int = SESSIONS):
    m = cfg.model
    S = m.seq_len
    wins = {}
    for sess in range(sessions):
        t = float(gen.uniform(0, 100))
        wins[sess] = []
        for _ in range(n_windows):
            imgs = gen.random((S, m.img_h, m.img_w, 3), np.float32) - 0.5
            imus = gen.standard_normal((10 * (S - 1) + 1, 6)).astype(np.float32)
            ts = t + np.cumsum(gen.uniform(0.08, 0.13, S))
            t = float(ts[-1])
            wins[sess].append((imgs, imus, ts))
    return wins


# per window: sessions to open first, then the sessions served
SCHEDULE = [([0, 1], [0, 1]), ([2], [0, 1, 2]), ([3], [0, 2, 3]), ([], [0, 1, 2, 3])]
IDLE = (2, 1)  # in window 2, session 1 idles


def same_carry(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def serve(engine: StreamingEngine, wins, expected=None, sessions=None):
    """Serves SCHEDULE, or its ``sessions`` alone where given (a step that
    serves none of them runs nothing). Returns the poses, the step times
    and the (K1, K2) launches of each step, which must equal ``expected``
    where given."""
    k1, k2 = cuda_kernels.fused_ode_solve, cuda_kernels.fused_cde_solve
    keep = set(wins if sessions is None else sessions)
    sids, nxt, poses, lat, launches = {}, {s: 0 for s in wins}, [], [], []
    for w, (opens, served) in enumerate(SCHEDULE):
        opens, served = [s for s in opens if s in keep], [s for s in served if s in keep]
        for s in opens:
            sids[s] = engine.open_session()
        before_idle = (engine.hidden(sids[IDLE[1]]) if w == IDLE[0] and IDLE[1] in keep
                       else None)
        batch = {sids[s]: wins[s][nxt[s]] for s in served}
        for s in served:
            nxt[s] += 1
        n0 = (k1.launches, k2.launches)
        t = time.perf_counter()
        out = engine.step(batch)
        lat.append(time.perf_counter() - t)
        launches.append((k1.launches - n0[0], k2.launches - n0[1]))
        for s in served:
            p = out[sids[s]]
            if p.shape != (10, 6) or not np.isfinite(p).all():
                raise AssertionError(f"window {w} session {s}: poses {p.shape} "
                                     f"finite={np.isfinite(p).all()}")
        poses.append({s: out[sids[s]] for s in served})
        if before_idle is not None and not same_carry(before_idle, engine.hidden(sids[IDLE[1]])):
            raise AssertionError("the idle session's carry changed")
    if expected is not None and launches != expected:
        raise AssertionError(f"(K1, K2) launches per step {launches}, expected {expected}")
    return poses, lat, launches


def profile_step(engine: StreamingEngine, wins, name: str = "profile") -> None:
    """Device time by kernel over one served step (all four sessions, their
    first windows again), from torch.profiler; the idle share is the part
    of the step's wall time with no kernel running (one stream, so kernel
    times do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    batch = {sid: wins[sid][0] for sid in range(SESSIONS)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step(batch)
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    phase(name, wall_ms=wall_ms, device_busy_ms=busy,
          idle_share=1.0 - busy / wall_ms if wall_ms else None,
          top_kernels_ms={k[:80]: v for k, v in top})


def run_slice(name: str, cfg, dev, expected, state_dict=None, model=None, wins=None):
    """``cfg``'s model (seeded init, or ``state_dict`` on it) behind
    StreamingEngine(max_sessions=4, fold_bn=True), serving SCHEDULE on
    ``wins`` (default: random windows from SEED) with the launch counts set
    to 0 just before and read just after. Returns the model, the engine, the
    windows, the poses and the (K1, K2) launches."""
    t = time.perf_counter()
    if model is None:
        model = create_model(cfg, seed=SEED, device=dev)
    init_s = time.perf_counter() - t
    if wins is None:
        wins = make_windows(cfg, np.random.default_rng(SEED), len(SCHEDULE))
    engine = StreamingEngine(model, state_dict, max_sessions=SESSIONS, fold_bn=True, device=dev)
    engine.warmup(wins[0][0])
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    poses, lat, per_step = serve(engine, wins, expected)
    launches = (cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_cde_solve.launches)
    phase(name, init_s=init_s, windows=len(SCHEDULE), steps_launches=per_step,
          launches=launches, incomplete=engine.incomplete(),
          incomplete_by_lane=engine.incomplete_by_lane().tolist(),
          step_ms=[x * 1e3 for x in lat], p50_step_ms=statistics.median(lat) * 1e3)
    return model, engine, wins, poses, launches


def meta_model(cfg, **model_fields):
    """``cfg``'s DeepVIO with ``model_fields`` replaced, without weights
    (the engine loads a state_dict into its own copy)."""
    with torch.device("meta"):
        return DeepVIO(dataclasses.replace(cfg.model, **model_fields), cfg.solver,
                       cfg.cde_solver_cfg)


def max_pose_diff(a, b) -> float:
    return max(float(np.abs(a[w][s] - b[w][s]).max()) for w in range(len(a)) for s in a[w])


def slice_phases(dev) -> int:
    cfg = flagship_config()
    model, engine, wins, poses, (launches, _) = run_slice(
        "slice", cfg, dev, [(10, 0)] * len(SCHEDULE))
    profile_step(engine, wins)
    _, core, _, core_poses, _ = run_slice("core_run", cfg, dev, [(0, 0)] * len(SCHEDULE),
                                          model.state_dict(), meta_model(cfg, use_kernels=False))
    # the bf16 encoders are the same on both paths; only the ODE solve
    # differs (kernel vs cuBLAS sums in f32), and its error control at
    # rtol 1e-2 lets the two land within 1e-3 of each other
    diff = max_pose_diff(poses, core_poses)
    if diff > 1e-3:
        raise AssertionError(f"kernel vs solver-core poses differ by {diff}")
    phase("core", max_abs_pose_diff=diff, incomplete=core.incomplete())
    return launches


def scaled(wins, factor: float):
    """The windows with images and IMU samples times ``factor``."""
    return {sess: [(factor * imgs, factor * imus, ts) for imgs, imus, ts in ws]
            for sess, ws in wins.items()}


def pose_core_gap(model, cfg, wins, dev) -> float:
    """How far rounding alone moves the cde poses on ``wins``: the pose core
    on the solver core in float32 and in float64, on the same features (the
    model's encoders), every session served every window with its state
    carried and its clock re-based as the engine does. The largest pose
    difference."""
    cores = []
    for dtype in (torch.float32, torch.float64):
        core = type(model.Pose_net)(dataclasses.replace(cfg.model, use_kernels=False),
                                    cfg.cde_solver_cfg)
        core.load_state_dict(model.Pose_net.state_dict())
        cores.append(core.to(dev, dtype).eval())
    carries, gap = [None, None], 0.0
    t_off = np.array([wins[sess][0][2][0] for sess in range(SESSIONS)])[:, None]
    with torch.inference_mode():
        for w in range(len(SCHEDULE)):
            imgs, imus, ts = (np.stack([wins[sess][w][k] for sess in range(SESSIONS)])
                              for k in range(3))
            fv = model.Image_net(torch.from_numpy(imgs).to(dev))
            fi = model.Inertial_net(torch.from_numpy(imus).to(dev))
            ts = torch.from_numpy((ts - t_off).astype(np.float32)).to(dev)
            poses = []
            for i, core in enumerate(cores):
                dtype = core.regressor[0].weight.dtype
                p, carries[i], _ = core(fv.to(dtype), fi.to(dtype), ts, carries[i])
                poses.append(p.double())
            gap = max(gap, float((poses[0] - poses[1]).abs().max()))
    return gap


def cde_phases(dev) -> dict:
    """The cde and rde pose cores behind the engine; returns K2's launches
    on each of the three served paths that run it."""
    cfg = cde_config()
    steps = len(SCHEDULE)
    model, engine, wins, _, (_, n_cde) = run_slice("slice_cde", cfg, dev, [(0, 1)] * steps)
    profile_step(engine, wins, "profile_cde")
    sd = model.state_dict()
    _, _, _, _, (_, n_hist) = run_slice("history_cde", cfg, dev,
                                        [(0, 1)] + [(0, 2)] * (steps - 1), sd,
                                        meta_model(cfg, cde_streaming_mode="history"))
    rde = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model_type="rde"))
    _, _, _, _, (_, n_rde) = run_slice("slice_rde", rde, dev, [(0, 1)] * steps)
    # K2 against the solver core, served. On the windows above the seeded
    # field's flow expands so far that rounding alone moves the poses by
    # about their own size (PERF.md): no tolerance can hold the two paths
    # together there. With the images and IMU samples x0.1 the path's
    # slopes are ~100x smaller; the two paths must agree within 4x how far
    # rounding alone moves the poses there (at least 1e-5).
    small = scaled(wins, CDE_CORE_SCALE)
    _, _, _, k2_poses, _ = run_slice("core_cde_k2", cfg, dev, [(0, 1)] * steps, sd,
                                     meta_model(cfg), small)
    _, core, _, core_poses, _ = run_slice("core_cde_run", cfg, dev, [(0, 0)] * steps, sd,
                                          meta_model(cfg, use_kernels=False), small)
    diff = max_pose_diff(k2_poses, core_poses)
    gap = pose_core_gap(model, cfg, small, dev)
    atol = max(1e-5, 4 * gap)
    size = np.abs(np.concatenate([p for w in k2_poses for p in w.values()]))
    phase("core_cde", max_abs_pose_diff=diff, pose_atol=atol, rounding_gap=gap,
          window_scale=CDE_CORE_SCALE, pose_abs_median=float(np.median(size)),
          pose_abs_max=float(size.max()), incomplete=core.incomplete())
    if diff > atol:
        raise AssertionError(f"K2 vs solver-core cde poses differ by {diff} (> {atol})")
    return {"cde": n_cde, "cde_history": n_hist, "rde": n_rde}


def trunk_shapes(batch: int):
    """(name, NCHW shape, dropout rate) of the conv trunk's nine
    activations for ``batch`` windows of the flagship configuration."""
    m = flagship_config().model
    h, w, n = m.img_h, m.img_w, batch * (m.seq_len - 1)
    out = []
    for name, (c, _, stride, rate) in zip(TRUNK_NAMES, TRUNK):
        h, w = (h - 1) // stride + 1, (w - 1) // stride + 1
        out.append((name, (n, c, h, w), rate))
    return out


# (name, shape, dtype, rate, element offset): the trunk's nine activations
# at B=2 in bf16 at their own rates; an odd-size float32 tensor (a tail of 3
# after the 4-element groups) at 0.2, 0.5 and 0.999; a bf16 tensor one
# element off a group's alignment (the kernel's scalar path)
DROPOUT_CASES = tuple((f"{name}_b2", shape, torch.bfloat16, rate, 0)
                      for name, shape, rate in trunk_shapes(2)) + (
    ("odd_f32_r0.2", (3, 5, 7, 11), torch.float32, 0.2, 0),
    ("odd_f32_r0.5", (3, 5, 7, 11), torch.float32, 0.5, 0),
    ("odd_f32_r0.999", (3, 5, 7, 11), torch.float32, 0.999, 0),
    ("unaligned_bf16", (1000003,), torch.bfloat16, 0.2, 1),
)


def check_dropout_case(case, dev, seed: int, channels_last: bool = False) -> dict:
    """One of DROPOUT_CASES through K3 and its plain version: forward and
    backward (FusedDropout with each) equal bit for bit, one launch each
    way, the keep fraction within 4 binomial sigmas. ``channels_last``
    lays out the input and the gradient as cuDNN gives the trunk's
    activations (dense, not contiguous)."""
    name, shape, dtype, rate, offset = case
    gen = torch.Generator(dev).manual_seed(seed)
    n = math.prod(shape)
    x = (0.5 + torch.rand(n + offset, generator=gen, device=dev)).to(dtype)[offset:].view(shape)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    if channels_last:
        x, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
        if x.is_contiguous():
            raise AssertionError(f"{name}: a channels-last {shape} is contiguous")
    key = int(torch.randint(0, 2 ** 62, (), generator=torch.Generator().manual_seed(seed)))
    n0 = cuda_kernels.fused_dropout.launches
    outs = {}
    for kernel in (True, False):
        xi = x.detach().requires_grad_()
        y = cuda_kernels.FusedDropout.apply(xi, key, rate, kernel)
        y.backward(g)
        outs[kernel] = (y.detach(), xi.grad)
    torch.cuda.synchronize()
    if cuda_kernels.fused_dropout.launches - n0 != 2:
        raise AssertionError(f"{name}: {cuda_kernels.fused_dropout.launches - n0} K3 "
                             "launches for one forward and one backward, expected 2")
    for k, what in ((0, "forward"), (1, "backward")):
        if not torch.equal(outs[True][k], outs[False][k]):
            bad = int((outs[True][k] != outs[False][k]).sum())
            raise AssertionError(f"{name}: {what} differs from the plain version in {bad} "
                                 f"of {n} elements")
    keep = float((outs[True][0] != 0).double().mean())
    sigma = math.sqrt(rate * (1 - rate) / n)
    if abs(keep - (1 - rate)) > 4 * sigma:
        raise AssertionError(f"{name}: keep fraction {keep}, expected {1 - rate} "
                             f"(4 sigma = {4 * sigma})")
    return {"elements": n, "keep": keep, "keep_sigmas": (keep - (1 - rate)) / sigma}


def dropout_bound(tensors) -> dict:
    """K3's bound on ``tensors``: each element read once and written once,
    at the HBM rate (Philox's integer work is far below the card's rate)."""
    nbytes = sum(2 * t.numel() * t.element_size() for t in tensors)
    return {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def kernel_dropout_check(dev) -> dict:
    cases = {c[0]: check_dropout_case(c, dev, SEED + i) for i, c in enumerate(DROPOUT_CASES)}
    batch = flagship_config().train.batch_size
    # the main path's calls as the trunk makes them: the nine activations
    # at B=16, channels-last, through FusedDropout forward and backward
    for i, (name, shape, rate) in enumerate(trunk_shapes(batch)):
        case = (f"{name}_b{batch}_channels_last", shape, torch.bfloat16, rate, 0)
        cases[case[0]] = check_dropout_case(case, dev, SEED + 100 + i, channels_last=True)
        torch.cuda.empty_cache()
    # the same nine calls on contiguous tensors: equal outputs, then times
    gen = torch.Generator(dev).manual_seed(SEED)
    acts = [(name, torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16), rate)
            for name, shape, rate in trunk_shapes(batch)]
    keys = [1 + i for i in range(len(acts))]

    def run(fn):
        return lambda: [fn(x, k, r) for (_, x, r), k in zip(acts, keys)]

    kernel = run(cuda_kernels.fused_dropout)
    plain = run(cuda_kernels.fused_dropout_plain)
    library = run(lambda x, k, r: F.dropout(x, r, training=True))
    for (name, x, _), yk, yp in zip(acts, kernel(), plain()):
        if not torch.equal(yk, yp):
            raise AssertionError(f"{name}_b{batch}: K3 differs from the plain version in "
                                 f"{int((yk != yp).sum())} of {x.numel()} elements")
        del yk, yp
    x0, r0 = acts[0][1], acts[0][2]                  # conv1's, the largest
    one = lambda fn: (lambda: fn(x0, 1, r0))  # noqa: E731
    times = {"ms": cuda_ms(kernel, runs=10), "plain_ms": cuda_ms(plain, runs=3, warmup=1),
             "library_ms": cuda_ms(library, runs=10)}
    times_largest = {"ms": cuda_ms(one(cuda_kernels.fused_dropout), runs=10),
                     "plain_ms": cuda_ms(one(cuda_kernels.fused_dropout_plain), runs=3, warmup=1),
                     "library_ms": cuda_ms(one(lambda x, k, r: F.dropout(x, r, training=True)),
                                           runs=10)}
    bd, bd_largest = dropout_bound([x for _, x, _ in acts]), dropout_bound([x0])
    phase("kernel_dropout", name="fused_dropout", cases=cases, max_abs_err=0.0,
          step_b16={"calls": len(acts), "elements": sum(x.numel() for _, x, _ in acts),
                    **times, **bd},
          largest_b16={"shape": list(x0.shape), **times_largest, **bd_largest})
    del acts, x0
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, **times, "bound_ms": bd["bound_ms"], "bound_by": "bytes"}


def train_batches(cfg, n: int, dev, seed: int):
    """``n`` seeded batches of ``cfg.train.batch_size`` windows on the
    card: images and IMU samples as the served windows, poses N(0, 0.1^2),
    frame intervals 0.08-0.13 s."""
    m, B = cfg.model, cfg.train.batch_size
    S = m.seq_len
    gen = torch.Generator(dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    return [(rand(B, S, m.img_h, m.img_w, 3) - 0.5,
             torch.randn((B, 10 * (S - 1) + 1, 6), generator=gen, device=dev),
             0.1 * torch.randn((B, S - 1, 6), generator=gen, device=dev),
             torch.cumsum(0.08 + 0.05 * rand(B, S), 1)) for _ in range(n)]


def train_config(**train_fields):
    cfg = flagship_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_fields))


def run_train(name: str, cfg, dev, steps: int, k3_per_step: int, carry: bool = False):
    """``steps`` train steps of ``cfg`` (seeded init and batches; the
    carried step with ``carry``) with the launch counts set to 0 just
    before and read just after. Checks the losses, the launches per step
    (K1 and K2 never), which weights moved and which did not. Returns the
    state, the step function, a batch, the K3 launches and the p50 step."""
    model = create_model(cfg, seed=SEED, device=dev, train=True)
    state = create_train_state(cfg, model, device=dev)
    step = make_train_step(cfg, carry=carry, device=dev)
    batches = train_batches(cfg, steps, dev, SEED)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    k1, k2, k3 = cuda_kernels.fused_ode_solve, cuda_kernels.fused_cde_solve, cuda_kernels.fused_dropout
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    rows = []
    for b in batches:
        n0, syncs = (k3.launches, k1.launches, k2.launches), odeint.host_syncs
        t = time.perf_counter()
        state, m = step(state, *b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "solver_incomplete": int(m["solver_incomplete"]),
                     "k3": k3.launches - n0[0], "k1": k1.launches - n0[1],
                     "k2": k2.launches - n0[2], "host_syncs": odeint.host_syncs - syncs})
    launches = k3.launches
    for i, r in enumerate(rows):
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"{name}: step {i} loss {r['loss']}")
        if (r["k3"], r["k1"], r["k2"]) != (k3_per_step, 0, 0):
            raise AssertionError(f"{name}: step {i} launched K3 {r['k3']}, K1 {r['k1']} and "
                                 f"K2 {r['k2']} times, expected {k3_per_step}, 0 and 0")
    after = model.state_dict()
    frozen = cfg.train.freeze_encoder
    eval_graph = frozen and cfg.train.frozen_encoder_eval
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    image_w = {k for k in after if k.startswith("Image_net.")
               and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    image_stats = {k for k in after if k.startswith("Image_net.") and "running_" in k}
    pose = {k for k in after if k.startswith("Pose_net.")}
    if frozen and moved & image_w:
        raise AssertionError(f"{name}: frozen image weights changed: {sorted(moved & image_w)[:4]}")
    if not frozen and image_w - moved:
        raise AssertionError(f"{name}: image weights did not move: {sorted(image_w - moved)[:4]}")
    if eval_graph and moved & image_stats:
        raise AssertionError(f"{name}: the folded encoder's statistics changed")
    stay = pose | (set() if eval_graph else image_stats)
    if stay - moved:
        raise AssertionError(f"{name}: unchanged: {sorted(stay - moved)[:4]}")
    p50 = statistics.median(r["ms"] for r in rows[1:])
    phase(name, batch=cfg.train.batch_size, carry=carry, steps=rows, launches=launches,
          p50_step_ms_after_first=p50,
          peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          image_weights_moved=len(moved & image_w), image_stats_moved=len(moved & image_stats),
          pose_params_moved=len(moved & pose))
    return state, step, batches[0], launches, p50


def train_plain(dev) -> int:
    """The first train step with K3 and with its plain version: the same
    init, generator seed and batch, cuDNN deterministic."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    batch = train_batches(flagship_config(), 1, dev, SEED)[0]
    losses, launches = {}, {}
    for use in (True, False):
        cfg = flagship_config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_kernels=use))
        state = create_train_state(cfg, create_model(cfg, seed=SEED, device=dev, train=True),
                                   device=dev)
        step = make_train_step(cfg, device=dev)
        cuda_kernels.reset_launch_counts()
        _, m = step(state, *batch)
        losses[use] = float(m["loss"])
        launches[use] = cuda_kernels.fused_dropout.launches
        del state
    torch.backends.cudnn.deterministic = False
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    phase("train_plain", loss_k3=losses[True], loss_plain=losses[False], rel_diff=rel,
          k3_launches=launches[True], k3_launches_plain=launches[False])
    if launches != {True: 9, False: 0}:
        raise AssertionError(f"train_plain: K3 launches {launches}, expected 9 and 0")
    if rel > 1e-6:
        raise AssertionError(f"train_plain: losses differ by {rel} relative (> 1e-6)")
    return launches[True]


def profile_train(state, step, batch) -> None:
    """Device time by kernel over one train step, from torch.profiler; the
    idle share is the part of the step's wall time with no kernel running
    (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    syncs = odeint.host_syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, *batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    syncs = odeint.host_syncs - syncs
    kernels, count = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
            count += ev.count
    busy = sum(kernels.values())
    share = lambda *words: sum(v for k, v in kernels.items()  # noqa: E731
                               if any(w in k.lower() for w in words))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    phase("profile_train", wall_ms=wall_ms, device_busy_ms=busy,
          idle_share=1.0 - busy / wall_ms, device_ops=count,
          k3_ms=share("fused_dropout"), conv_ms=share("conv", "xmma", "cudnn", "implicit"),
          solver_host_syncs=syncs, top_kernels_ms={k[:80]: v for k, v in top})


def train_phases(dev) -> dict:
    """The three training paths that run K3; returns its launches on each."""
    state, step, batch, n_train, _ = run_train("train", train_config(), dev, 4, 9)
    profile_train(state, step, batch)
    del state, step, batch
    _, _, _, n_enc, _ = run_train("train_encoder", train_config(freeze_encoder=False), dev, 3, 18)
    run_train("train_frozen_eval", train_config(frozen_encoder_eval=True), dev, 3, 0)
    torch.cuda.empty_cache()
    return {"train": n_train, "train_encoder": n_enc, "train_plain": train_plain(dev)}


# ---------------------------------------------------------------------------
# Streaming KITTI evaluation and the test / serve command lines
# ---------------------------------------------------------------------------

EVAL_SEQS = ("05", "07", "10")
EVAL_FRAMES = 111            # 11 windows a sequence (real: 2,761 / 1,101 / 1,201)
KITTI_HW = (376, 1241)       # KITTI's raw image size
EVAL_SPEED_SCALE = 15.0      # ~1.5 m a frame: each sequence covers > 100 m
DECODE_THREADS = 4
EVAL_DROPOUTS = (0.0, 0.3)   # no eval dropout, and the flagship's own
# the keys of the JAX package's serve reports (ode_vio_tpu/cli/serve.py);
# the single-session one adds solver_incomplete only where it is not 0
SERVE_KEYS = {"seq", "windows", "frames", "latency_ms_p50", "latency_ms_p90",
              "latency_ms_p99", "frames_per_sec", "t_rmse", "trajectory"}
SERVE_MULTI_KEYS = {"sessions", "steps", "frames", "latency_ms_p50", "latency_ms_p90",
                    "latency_ms_p99", "frames_per_sec", "t_rmse", "solver_incomplete"}
SERVE_P50_LIMIT_MS = 1000.0  # a window spans ~1 s of driving
EVAL_POSE_ATOL = 1e-3        # the core phase's limit: two rtol 1e-2 solves


def eval_config():
    """The configuration the eval phases drive (the flagship's)."""
    return flagship_config()


def model_flags(cfg) -> list:
    """Command-line flags that build ``cfg``'s model and solver."""
    m, s = cfg.model, cfg.solver
    return ["--model_type", m.model_type, "--img_h", str(m.img_h), "--img_w", str(m.img_w),
            "--seq_len", str(m.seq_len), "--v_f_len", str(m.v_f_len),
            "--i_f_len", str(m.i_f_len), "--fuse_method", m.fuse_method,
            "--ode_hidden_dim", str(m.ode_hidden_dim),
            "--ode_fn_num_layers", str(m.ode_fn_num_layers),
            "--ode_activation_fn", m.ode_activation_fn,
            "--rnn_num_layers", str(m.rnn_num_layers), "--compute_dtype", m.compute_dtype,
            "--ode_rnn_type", m.ode_rnn_type, "--rnn_hidden_dim", str(m.rnn_hidden_dim),
            "--cde_hidden_dim", str(m.cde_hidden_dim),
            "--ode_solver", s.method, "--ode_rtol", str(s.rtol), "--ode_atol", str(s.atol),
            "--ode_max_steps", str(s.max_steps)]


def check_launches(what: str, got: int, want: int) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got} launches, expected {want}")


def eval_data(work: Path) -> Path:
    """The synthetic KITTI tree at KITTI's image size, written by the port's
    own writer; the decoder built, and its rate at 376x1241 -> 256x512."""
    m = eval_config().model
    t = time.perf_counter()
    root = make_kitti_tree(work / "kitti", seqs=EVAL_SEQS, n_frames=EVAL_FRAMES,
                           img_hw=KITTI_HW, seed=SEED, speed_scale=EVAL_SPEED_SCALE)
    write_s = time.perf_counter() - t
    pngs = sorted(root.glob("sequences/*/image_2/*.png"))
    lengths = {}
    for seq in EVAL_SEQS:
        dist, _ = geometry.trajectory_distances(load_sequence(root, seq).abs_poses)
        lengths[seq] = float(dist[-1])
        if dist[-1] <= 100.0:
            raise AssertionError(f"eval_data: sequence {seq} covers {dist[-1]} m (<= 100)")
    t = time.perf_counter()
    native = native_loader.is_available()
    build_s = time.perf_counter() - t
    batch = pngs[:4 * m.seq_len]
    native_loader.decode_batch(batch[:2], (m.img_h, m.img_w))  # the fallback's first import
    t = time.perf_counter()
    imgs = native_loader.decode_batch(batch, (m.img_h, m.img_w), threads=DECODE_THREADS)
    decode_s = time.perf_counter() - t
    if imgs.shape != (len(batch), m.img_h, m.img_w, 3) or not (
            imgs.min() >= 0.0 and imgs.max() <= 1.0):
        raise AssertionError(f"eval_data: decoded {imgs.shape}, range "
                             f"[{imgs.min()}, {imgs.max()}]")
    phase("eval_data", sequences=list(EVAL_SEQS), frames=EVAL_FRAMES, image_hw=list(KITTI_HW),
          png_bytes=sum(p.stat().st_size for p in pngs), write_s=write_s,
          sequence_m=lengths, native=native, build_s=build_s,
          build_error=native_loader.build_error(), decode_threads=DECODE_THREADS,
          decode_frames_per_s=len(batch) / decode_s, decode_to=[m.img_h, m.img_w])
    return root


def recorder(infer, log):
    """``infer`` with each call's poses appended to ``log`` (numpy)."""
    def rec(imgs, imus, ts, carry=None):
        poses, carry = infer(imgs, imus, ts, carry)
        log.append(poses.cpu().numpy())
        return poses, carry

    rec.device = infer.device
    return rec


def lane_poses(log, parts, batched: bool):
    """Each partition's per-frame poses from a stream's recorded calls:
    one call per window step with a lane per partition (batched), or the
    partitions one after another, one window a call."""
    out, k = [], 0
    for lane, part in enumerate(parts):
        rows = []
        for i, w in enumerate(part.windows):
            poses = log[i][lane] if batched else log[k + i][0]
            rows.append(poses[: part.seq_len - 1 - w["pad"]])
        k += 0 if batched else len(part)
        out.append(np.concatenate(rows))
    return out


def evaluator(root, cfg, dropout: float):
    m = cfg.model
    return KittiEvaluator(root, EVAL_SEQS, m.seq_len, (m.img_h, m.img_w), dropout,
                          rng=np.random.default_rng(SEED))


def stream(infer, root, cfg, dropout: float, batched: bool, name: str, k1_per_step: int):
    """One stream of the three sequences with K1's count set to 0 just
    before and read just after, which must be ``k1_per_step`` a window
    step: (evaluator, per-sequence poses, launches)."""
    ev = evaluator(root, cfg, dropout)
    log = []
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    res = ev.eval(recorder(infer, log), batched=batched)
    launches = cuda_kernels.fused_ode_solve.launches
    steps = max(len(p) for p in ev.partitions) if batched else sum(map(len, ev.partitions))
    check_launches(f"{name} K1", launches, k1_per_step * steps)
    for seq, r in zip(EVAL_SEQS, res):
        if not all(math.isfinite(r[k]) for k in METRICS):
            raise AssertionError(f"{name}: sequence {seq} metrics {r}")
    return ev, lane_poses(log, ev.partitions, batched), launches


def profile_eval(infer, root, cfg) -> dict:
    """Device time over one batched stream (eval dropout 0), from
    torch.profiler; the idle share is the part of its wall time with no
    kernel running (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    ev = evaluator(root, cfg, 0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.eval(infer, batched=True)
    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + dev_us / 1e3
    busy = sum(kernels.values())
    wall_ms = ev.timing["wall_s"] * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_ms_per_step": busy / ev.timing["steps"],
            "idle_share": 1.0 - busy / wall_ms, "top_kernels_ms": {k[:80]: v for k, v in top}}


def eval_stream(dev, root) -> dict:
    """The flagship ode-rnn (seed 0) through make_infer_fn(fold_bn=True)
    and KittiEvaluator at eval dropout 0 and 0.3: batched (3 lanes) and
    sequential, K1 10 launches a window step; the two agree, and the
    kernel path agrees with use_kernels=False, within 1e-3. Returns K1's
    launches on the batched and the sequential streams."""
    cfg = eval_config()
    model = create_model(cfg, seed=SEED, device=dev)
    infer = make_infer_fn(model, fold_bn=True, device=dev)
    plain = make_infer_fn(meta_model(cfg, use_kernels=False), model.state_dict(), fold_bn=True,
                          device=dev)
    # a cold and a carried window through each callable first, so the first
    # timed stream pays no one-time cost (cuDNN's plans, first launches)
    warm = evaluator(root, cfg, 0.0).partitions[0][0]
    x = tuple(torch.from_numpy(a[None]).to(dev) for a in (warm.imgs, warm.imus, warm.ts))
    for f in (infer, plain):
        f(*x, f(*x)[1])[0].cpu()
    per_step = cfg.model.seq_len - 1            # one K1 launch a frame interval
    launches = {"eval_batched": 0, "eval_sequential": 0}
    runs = {}
    for dropout in EVAL_DROPOUTS:
        infer.reset_incomplete()
        ev_b, poses_b, n_b = stream(infer, root, cfg, dropout, True, "eval_batched", per_step)
        incomplete_b = infer.incomplete()
        ev_s, poses_s, n_s = stream(infer, root, cfg, dropout, False, "eval_sequential",
                                    per_step)
        launches["eval_batched"] += n_b
        launches["eval_sequential"] += n_s
        _, poses_p, _ = stream(plain, root, cfg, dropout, True, "eval_plain", 0)
        seq_diff = max(float(np.abs(a - b).max()) for a, b in zip(poses_b, poses_s))
        plain_diff = max(float(np.abs(a - b).max()) for a, b in zip(poses_b, poses_p))
        runs[str(dropout)] = {
            "frames": [len(p) for p in poses_b],
            "windows": [len(p) for p in ev_b.partitions],
            "metrics": {seq: {k: r[k] for k in METRICS}
                        for seq, r in zip(EVAL_SEQS, ev_b.results)},
            "batched_vs_sequential": seq_diff, "kernel_vs_plain": plain_diff,
            "incomplete": incomplete_b, "incomplete_all_streams": infer.incomplete(),
            **{f"{kind}_{k}": t[k] for kind, t in (("batched", ev_b.timing),
                                                  ("sequential", ev_s.timing))
               for k in ("wall_s", "decode_wait_s", "steps", "frames")},
            "batched_frames_per_s": ev_b.timing["frames"] / ev_b.timing["wall_s"],
            "sequential_frames_per_s": ev_s.timing["frames"] / ev_s.timing["wall_s"],
            "batched_decode_wait_share": ev_b.timing["decode_wait_s"] / ev_b.timing["wall_s"],
            "sequential_decode_wait_share": ev_s.timing["decode_wait_s"] / ev_s.timing["wall_s"],
        }
        if seq_diff > EVAL_POSE_ATOL or plain_diff > EVAL_POSE_ATOL:
            raise AssertionError(f"eval_stream dropout {dropout}: batched vs sequential "
                                 f"{seq_diff}, kernel vs plain {plain_diff} (> {EVAL_POSE_ATOL})")
    # the same weights with float32 encoders: how much of the batched vs
    # sequential gap the bf16 convolutions make (printed, not bounded)
    f32 = make_infer_fn(meta_model(cfg, compute_dtype="float32"), model.state_dict(),
                        fold_bn=True, device=dev)
    launches["eval_f32"] = 0
    for dropout in EVAL_DROPOUTS:
        _, poses_b, n_b = stream(f32, root, cfg, dropout, True, "eval_f32_batched", per_step)
        _, poses_s, n_s = stream(f32, root, cfg, dropout, False, "eval_f32_sequential", per_step)
        launches["eval_f32"] += n_b + n_s
        runs[str(dropout)]["batched_vs_sequential_f32"] = max(
            float(np.abs(a - b).max()) for a, b in zip(poses_b, poses_s))
    phase("eval_stream", pose_atol=EVAL_POSE_ATOL, launches=launches, runs=runs,
          profile=profile_eval(infer, root, cfg))
    return {"model": model, "launches": launches}


def summary_means(path: Path) -> dict:
    """{seq: {metric: mean}} from cli.test's summary.txt."""
    out = {}
    for line in path.read_text().splitlines():
        seq, stats = line.split(": ", 1)
        out[seq.split()[-1]] = {k: float(v) for k, v in re.findall(r"(\w+): (\S+) \+-", stats)}
    return out


def check_summary(name: str, path: Path, seqs) -> dict:
    means = summary_means(path)
    if sorted(means) != sorted(seqs) or not all(
            len(v) == len(METRICS) and all(math.isfinite(x) for x in v.values())
            for v in means.values()):
        raise AssertionError(f"{name}: summary {means}")
    return means


def eval_cli(dev, work: Path, root, model) -> dict:
    """cli.test on the flagship model saved as a reference-layout .pth:
    --batch_runs --run_times 2 --eval_data_dropout 0.3 (6 lanes), then
    --model_type cde on one sequence (K2 once a window). Returns the
    launches of both runs."""
    cfg = eval_config()
    pth = work / "flagship.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, pth)
    common = ["--data_dir", str(root), "--save_dir", str(work / "results"), "--device", str(dev)]
    parsed = config_from_args(build_parser().parse_args(model_flags(cfg)))
    if (parsed.model, parsed.solver) != (cfg.model, cfg.solver):
        raise AssertionError(f"eval_cli: the flags build {parsed.model}, {parsed.solver}, "
                             f"not {cfg.model}, {cfg.solver}")
    runs, dropout = 2, 0.3
    # the command line's partitions: run r draws its dropout from seed + r
    steps = max(len(p) for r in range(runs) for p in KittiEvaluator(
        root, EVAL_SEQS, cfg.model.seq_len, eval_dropout=dropout,
        rng=np.random.default_rng(SEED + r)).partitions)
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    t = time.perf_counter()
    cli_test_main(["--experiment_name", "flagship", "--pretrain", str(pth), *common,
                   *model_flags(cfg), "--val_seq", *EVAL_SEQS, "--batch_runs",
                   "--run_times", str(runs), "--eval_data_dropout", str(dropout),
                   "--seed", str(SEED)])
    wall_s = time.perf_counter() - t
    k1 = cuda_kernels.fused_ode_solve.launches
    check_launches("eval_cli K1", k1, (cfg.model.seq_len - 1) * steps)
    out = work / "results" / "flagship_test"
    means = check_summary("eval_cli", out / "summary.txt", EVAL_SEQS)
    for seq in EVAL_SEQS:
        for kind in ("pred", "gt"):
            if not (out / "poses" / f"{seq}_{kind}.txt").exists():
                raise AssertionError(f"eval_cli: no pose dump {seq}_{kind}.txt")
    cde_windows = len(EvalPartition(root, EVAL_SEQS[0], cfg.model.seq_len))
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    t = time.perf_counter()
    cli_test_main(["--experiment_name", "cde", *common, *model_flags(cfg),
                   "--model_type", "cde", "--val_seq", EVAL_SEQS[0], "--seed", str(SEED)])
    cde_wall_s = time.perf_counter() - t
    k2 = cuda_kernels.fused_cde_solve.launches
    check_launches("eval_cli cde K2", k2, cde_windows)
    check_launches("eval_cli cde K1", cuda_kernels.fused_ode_solve.launches, 0)
    cde_means = check_summary("eval_cli cde", work / "results" / "cde_test" / "summary.txt",
                              EVAL_SEQS[:1])
    phase("eval_cli", lanes=runs * len(EVAL_SEQS), window_steps=steps, wall_s=wall_s,
          k1_launches=k1, summary=means, cde_windows=cde_windows, cde_k2_launches=k2,
          cde_wall_s=cde_wall_s, cde_summary=cde_means)
    return {"k1": k1, "k2": k2, "pth": pth}


def serve_cli(dev, work: Path, root, pth: Path) -> dict:
    """cli.serve on one sequence, then on the three as sessions of one
    engine; both reports printed as they come, with the JAX package's keys
    and p50 under 1 s. Returns K1's launches of both runs."""
    cfg = eval_config()
    common = ["--data_dir", str(root), "--save_dir", str(work / "results"), "--device", str(dev),
              "--pretrain", str(pth), *model_flags(cfg)]
    out, launches = {}, {}
    for name, seqs, keys in (("serve_cli_single", EVAL_SEQS[:1], SERVE_KEYS),
                             ("serve_cli_multi", EVAL_SEQS, SERVE_MULTI_KEYS)):
        timing = {}
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        report = serve_main(["--experiment_name", name, *common, "--val_seq", *seqs],
                            timing=timing)
        launches[name] = cuda_kernels.fused_ode_solve.launches
        steps = report["windows"] if len(seqs) == 1 else report["steps"]
        # the warm-up runs the cold-start forward once at each encoder
        # bucket of the engine's lanes (a lane a sequence) and the carried
        # forward once
        warm = len({encoder_bucket(k, len(seqs)) for k in range(1, len(seqs) + 1)}) + 1
        check_launches(f"{name} K1", launches[name], (cfg.model.seq_len - 1) * (steps + warm))
        if set(report) - {"solver_incomplete"} != keys - {"solver_incomplete"} or (
                len(seqs) > 1 and set(report) != keys):
            raise AssertionError(f"{name}: report keys {sorted(report)}")
        if not report["latency_ms_p50"] < SERVE_P50_LIMIT_MS:
            raise AssertionError(f"{name}: p50 {report['latency_ms_p50']} ms "
                                 f"(>= {SERVE_P50_LIMIT_MS})")
        out[name] = {"wall_s": timing["wall_s"], "decode_wait_s": timing["decode_wait_s"],
                     "decode_wait_share": timing["decode_wait_s"] / timing["wall_s"],
                     "launches": launches[name]}
    phase("serve_cli", **out)
    return launches


# ---------------------------------------------------------------------------
# The training command line
# ---------------------------------------------------------------------------

TRAIN_SEQS, TRAIN_VAL_SEQS = ("05", "07"), ("10",)


def train_cli_flags(root, save: Path, dev, epochs: int, model_type: str = "ode-rnn",
                    train_seqs=TRAIN_SEQS) -> list:
    """cli.train's flags for the flagship's train configuration (B=16,
    frozen encoder, frame dropout 0.3 +- 0.1 in training and 0.3 in the
    evaluation, K3 on the trunk) with ``model_type``'s core, ``epochs``
    epochs on ``train_seqs``, a checkpoint every epoch."""
    cfg = train_config()
    d, t = cfg.data, cfg.train
    flags = ["--data_dir", str(root), "--save_dir", str(save), "--device", str(dev),
             *model_flags(cfg), "--model_type", model_type,
             "--train_seq", *train_seqs, "--val_seq", *TRAIN_VAL_SEQS,
             "--batch_size", str(t.batch_size), "--freeze_encoder",
             "--data_dropout", str(d.data_dropout), "--data_dropout_std", str(d.data_dropout_std),
             "--eval_data_dropout", str(d.eval_data_dropout), "--seed", str(SEED),
             "--epochs_warmup", str(epochs), "--epochs_joint", "0", "--epochs_fine", "0",
             "--ckpt_every", "1"]
    parsed = config_from_args(build_parser().parse_args(flags))
    want = dataclasses.replace(cfg.model, model_type=model_type)
    if (parsed.model, parsed.solver, parsed.train.freeze_encoder, parsed.data.data_dropout,
            parsed.data.data_dropout_std, parsed.data.eval_data_dropout) != (
            want, cfg.solver, True, d.data_dropout, d.data_dropout_std, d.eval_data_dropout):
        raise AssertionError(f"train_cli: the flags build {parsed}, not the flagship's")
    return flags


def train_cli_counts(flags, epochs) -> tuple:
    """cli.train's batches in each of ``epochs`` and its evaluation's window
    steps (one sequence: one window a step), from the loader and the
    partitions the command line builds."""
    from ode_vio_tpu_torch.cli.train import get_train_loader

    cfg = config_from_args(build_parser().parse_args(flags))
    quiet = logging.getLogger("chip_smoke.counts")
    steps = [len(get_train_loader(cfg, e, quiet)) for e in epochs]
    evals = [len(EvalPartition(cfg.data.data_dir, cfg.data.val_seq[0], cfg.data.seq_len,
                               (cfg.model.img_h, cfg.model.img_w), cfg.data.eval_data_dropout,
                               np.random.default_rng(cfg.train.seed + 7919 + e)))
             for e in epochs]
    return steps, evals


def epoch_report(cfg, timing) -> list:
    """Per epoch: wall seconds of training and evaluation, the steps with
    their p50 (the run's first step left out), trained frame pairs per
    second at that p50, eval frames per second, loss, t_rel, truncated
    solves by step."""
    out, first = [], True
    for e in timing["epochs"]:
        ms = [s["s"] * 1e3 for s in e["steps"]][1 if first else 0:]
        first = False
        p50 = statistics.median(ms)
        ev = e["eval_timing"]
        out.append({"epoch": e["epoch"], "train_s": e["train_s"], "eval_s": e["eval_s"],
                    "steps": len(e["steps"]), "p50_step_ms": p50,
                    "frame_pairs_per_s": cfg.train.batch_size * (cfg.model.seq_len - 1) / p50 * 1e3,
                    "eval_frames_per_s": ev["frames"] / ev["wall_s"],
                    "eval_decode_wait_share": ev["decode_wait_s"] / ev["wall_s"],
                    "loss": e["loss"], "t_rel": e["t_rel"], "r_rel": e["r_rel"],
                    "solver_incomplete_by_step": [s["solver_incomplete"] for s in e["steps"]],
                    "eval_incomplete": e["eval_incomplete"]})
        if not math.isfinite(e["loss"]) or not all(math.isfinite(s["loss"]) for s in e["steps"]):
            raise AssertionError(f"train_cli: epoch {e['epoch']} losses {e['loss']}")
    return out


def tensor_gaps(a, b, path="") -> dict:
    """{path: largest |a - b|} of every tensor of two nested checkpoints
    that differs (non-tensor leaves: path -> both values)."""
    if isinstance(a, torch.Tensor):
        if a.shape == b.shape and torch.equal(a.cpu(), b.cpu()):
            return {}
        d = (a.cpu().double() - b.cpu().double()).abs().max() if a.shape == b.shape else math.inf
        return {path: float(d)}
    if isinstance(a, dict):
        return {k: v for key in a for k, v in tensor_gaps(a[key], b.get(key), f"{path}.{key}").items()}
    if isinstance(a, (list, tuple)):
        return {k: v for i, (x, y) in enumerate(zip(a, b))
                for k, v in tensor_gaps(x, y, f"{path}[{i}]").items()}
    return {} if a == b else {path: [a, b]}


def run_train_cli(name: str, args: list, steps: list, evals: list, k1_per_eval: int,
                  k2_per_eval: int) -> tuple:
    """cli.train with the launch counts set to 0 just before and read just
    after: K3 9 a step, K1 and K2 as given per eval window."""
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    timing = {}
    t = time.perf_counter()
    train_main(args, timing=timing)
    wall = time.perf_counter() - t
    got = {k: getattr(cuda_kernels, k).launches
           for k in ("fused_dropout", "fused_ode_solve", "fused_cde_solve")}
    check_launches(f"{name} K3", got["fused_dropout"], 9 * sum(steps))
    check_launches(f"{name} K1", got["fused_ode_solve"], k1_per_eval * sum(evals))
    check_launches(f"{name} K2", got["fused_cde_solve"], k2_per_eval * sum(evals))
    if [len(e["steps"]) for e in timing["epochs"]] != steps:
        raise AssertionError(f"{name}: steps {[len(e['steps']) for e in timing['epochs']]}, "
                             f"expected {steps}")
    return timing, wall, got


def split_run(name: str, flags: list, save: Path, dev, per_eval: int) -> dict:
    """cli.train ``flags`` for two epochs in one run, then epoch 0 and a run
    resumed from its checkpoints directory for epoch 1 (K1 ``per_eval`` a
    window of the evaluation, K2 never). Returns each run's epoch reports,
    wall and launches, the continuous run's peak memory, and the gaps
    between the two epoch_001 checkpoints (empty: bitwise equal)."""
    cfg = config_from_args(build_parser().parse_args(flags))
    steps, evals = train_cli_counts(flags, (0, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cont, cont_s, n_cont = run_train_cli(name, ["--experiment_name", "cont", *flags],
                                         steps, evals, per_eval, 0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    split_dir = save / "split" / "checkpoints"
    split0, split0_s, n_split0 = run_train_cli(
        f"{name}_split", ["--experiment_name", "split", *flags, "--epochs_warmup", "1"],
        steps[:1], evals[:1], per_eval, 0)
    split1, split1_s, n_split1 = run_train_cli(
        f"{name}_resume", ["--experiment_name", "split", *flags, "--pretrain", str(split_dir)],
        steps[1:], evals[1:], per_eval, 0)
    a = CheckpointManager(save / "cont" / "checkpoints").restore_raw("epoch_001")
    b = CheckpointManager(split_dir).restore_raw("epoch_001")
    return {"steps_by_epoch": steps, "eval_windows_by_epoch": evals,
            "continuous": epoch_report(cfg, cont), "continuous_wall_s": cont_s,
            "split": epoch_report(cfg, split0) + epoch_report(cfg, split1),
            "split_wall_s": [split0_s, split1_s], "peak_memory_gib": peak,
            "launches": {"continuous": n_cont, "split": n_split0, "resume": n_split1},
            "gaps": tensor_gaps(a, b), "split_dir": split_dir, "epoch_001": b}


def split_launches(run: dict, kernel: str) -> tuple:
    """(continuous, split + resume) launches of ``kernel`` in a split run."""
    n = run["launches"]
    return n["continuous"][kernel], n["split"][kernel] + n["resume"][kernel]


def train_cli(dev, work: Path, root) -> dict:
    """cli.train on the flagship at B=16 over the synthetic tree: two
    epochs in one run, then epoch 0 and a run resumed from its checkpoints
    directory for epoch 1; the two epoch_001 checkpoints compared, and the
    split run's restored into a fresh state on the card bit for bit.
    Returns K3's and K1's launches on each run."""
    cfg = train_config()
    save = work / "train_cli"
    run = split_run("train_cli", train_cli_flags(root, save, dev, epochs=2), save, dev,
                    cfg.model.seq_len - 1)
    gaps, b = run.pop("gaps"), run.pop("epoch_001")
    # the round trip on the card: epoch_001 restored into a fresh state
    state = create_train_state(cfg, create_model(cfg, seed=SEED + 5, device=dev, train=True),
                               device=dev)
    state = CheckpointManager(run.pop("split_dir")).restore("epoch_001", state)
    restored = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step, "generator": state.generator.get_state()}
    round_trip = tensor_gaps(restored, b)
    phase("train_cli", batch=cfg.train.batch_size, train_seqs=list(TRAIN_SEQS),
          val_seqs=list(TRAIN_VAL_SEQS), **run,
          split_vs_continuous_epoch_001=gaps or "bitwise equal",
          round_trip=round_trip or "bitwise equal")
    if round_trip:
        raise AssertionError(f"train_cli: the restored checkpoint differs: {round_trip}")
    if gaps:
        raise AssertionError(f"train_cli: split run's epoch_001 differs from the continuous "
                             f"run's: {gaps}")
    del state
    torch.cuda.empty_cache()
    (k3, k3_split), (k1, k1_split) = (split_launches(run, k) for k in
                                      ("fused_dropout", "fused_ode_solve"))
    return {"k3": {"train_cli": k3, "train_cli_split": k3_split},
            "k1": {"train_cli_eval": k1, "train_cli_split_eval": k1_split}}


def train_cli_cde(dev, work: Path, root) -> dict:
    """One epoch of cli.train --model_type cde at full width, evaluated
    through K2 (one launch a window, none in a train step); then two rde
    train steps at B=16 through make_train_step, which launch no K2.
    Returns K2's and K3's launches."""
    cfg = train_config()
    flags = train_cli_flags(root, work / "train_cli_cde", dev, epochs=1, model_type="cde")
    steps, evals = train_cli_counts(flags, (0,))
    timing, wall, n = run_train_cli("train_cli_cde", ["--experiment_name", "cde", *flags],
                                    steps, evals, 0, 1)
    rde = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model_type="rde"))
    state = create_train_state(rde, create_model(rde, seed=SEED, device=dev, train=True),
                               device=dev)
    step = make_train_step(rde, device=dev)
    batches = train_batches(rde, 2, dev, SEED)
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    rde_rows = []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, *b)
        rde_rows.append({"ms": (time.perf_counter() - t) * 1e3, "loss": float(m["loss"]),
                         "solver_incomplete": int(m["solver_incomplete"])})
    n_rde = {k: getattr(cuda_kernels, k).launches
             for k in ("fused_dropout", "fused_ode_solve", "fused_cde_solve")}
    phase("train_cli_cde", cde=epoch_report(cfg, timing), cde_wall_s=wall, launches=n,
          eval_windows=evals, rde_steps=rde_rows, rde_launches=n_rde)
    check_launches("train_rde K3", n_rde["fused_dropout"], 9 * len(batches))
    check_launches("train_rde K2", n_rde["fused_cde_solve"], 0)
    if not all(math.isfinite(r["loss"]) for r in rde_rows):
        raise AssertionError(f"train_rde: losses {rde_rows}")
    del state
    torch.cuda.empty_cache()
    return {"k2": n["fused_cde_solve"], "k3": n["fused_dropout"],
            "k3_rde": n_rde["fused_dropout"]}


# ---------------------------------------------------------------------------
# Carried-state and TBPTT training
# ---------------------------------------------------------------------------

TBPTT_CHAIN = 8
TBPTT_SEQS = ("00", "01")    # train_tbptt's own training sequences
TBPTT_FRAMES = 200           # 20 chain chunks at the epoch's drawn ratio: one group of 16
TBPTT_HW = (256, 512)        # written at the model's size: decode does no resize


def recording_factory(factory, log: list):
    """``factory`` (a train-step factory of cli.train) whose steps append
    to ``log`` the device's peak memory of the step (reset just before),
    that peak above the memory allocated when the step began, and whether
    it was handed a carry."""
    def build(*args, **kwargs):
        step = factory(*args, **kwargs)

        def rec(state, *batch):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = step(state, *batch)
            float(out[1]["loss"])
            peak = torch.cuda.max_memory_allocated()
            log.append({"peak_gib": peak / 2 ** 30, "over_base_gib": (peak - base) / 2 ** 30,
                        "carried": len(batch) > 4 and batch[4] is not None})
            return out

        return rec

    return build


def train_tbptt(dev, work: Path, root) -> dict:
    """cli.train --model_type cde --tbptt_chain 8 for one epoch at the
    flagship's train configuration on two training sequences of its own,
    evaluated on sequence 10 through K2: chunk and step counts, K3 9 a step,
    K2 once a window of the evaluation and never in a step, K1 never; the
    carry reset every 8 steps; the peak memory of a chain's last step no
    higher than its second's. Returns K2's and K3's launches."""
    t = time.perf_counter()
    make_kitti_tree(root, seqs=TBPTT_SEQS, n_frames=TBPTT_FRAMES, img_hw=TBPTT_HW,
                    seed=SEED + 1, speed_scale=EVAL_SPEED_SCALE)
    write_s = time.perf_counter() - t
    cfg = train_config()
    flags = [*train_cli_flags(root, work / "train_tbptt", dev, 1, "cde", TBPTT_SEQS),
             "--tbptt_chain", str(TBPTT_CHAIN)]
    steps, evals = train_cli_counts(flags, (0,))
    from ode_vio_tpu_torch.cli import train as train_module

    loader = train_module.get_train_loader(config_from_args(build_parser().parse_args(flags)), 0,
                                           logging.getLogger("chip_smoke.counts"))
    chunks = len(loader.sampler.chunks)
    if chunks < cfg.train.batch_size or steps[0] < TBPTT_CHAIN:
        raise AssertionError(f"train_tbptt: {chunks} chunks, {steps} steps")
    log, factory = [], train_module.make_streaming_train_step
    train_module.make_streaming_train_step = recording_factory(factory, log)
    try:
        timing, wall, n = run_train_cli("train_tbptt", ["--experiment_name", "tbptt", *flags],
                                        steps, evals, 0, 1)
    finally:
        train_module.make_streaming_train_step = factory
    carried = [r["carried"] for r in log]
    if carried != [i % TBPTT_CHAIN != 0 for i in range(steps[0])]:
        raise AssertionError(f"train_tbptt: carried by step {carried}")
    recs = timing["epochs"][0]["steps"]
    ms = [r["s"] * 1e3 for r in recs]
    peaks = [r["peak_gib"] for r in log]
    chains = [peaks[i:i + TBPTT_CHAIN] for i in range(0, len(peaks), TBPTT_CHAIN)]
    phase("train_tbptt", chain=TBPTT_CHAIN, train_seqs=list(TBPTT_SEQS), frames=TBPTT_FRAMES,
          image_hw=list(TBPTT_HW), write_s=write_s, chunks=chunks, steps=steps[0],
          eval_windows=evals, epoch=epoch_report(cfg, timing), wall_s=wall, launches=n,
          p50_cold_step_ms=statistics.median(ms[::TBPTT_CHAIN]),
          p50_carried_step_ms=statistics.median(m for i, m in enumerate(ms)
                                                if i % TBPTT_CHAIN),
          peak_gib_by_step=peaks, solver_incomplete_by_step=[r["solver_incomplete"] for r in recs])
    for c in chains:
        if c[-1] > c[1] * 1.01:
            raise AssertionError(f"train_tbptt: peak memory grows along a chain: {c}")
    return {"k2": n["fused_cde_solve"], "k3": n["fused_dropout"]}


def exposure_draws(flags: list, epoch: int, steps: int) -> list:
    """Which of an epoch's steps cli.train ``flags`` makes carried (the
    draws of its ``_exposure_step``)."""
    from ode_vio_tpu_torch.cli.train import _exposure_step

    cfg = config_from_args(build_parser().parse_args(flags))
    step = _exposure_step(lambda *a: False, lambda *a: True, cfg, epoch)
    return [step(None) for _ in range(steps)]


def train_carry(dev, work: Path, root) -> dict:
    """cli.train --carry_exposure: one cde epoch at 0.2 (K2 only in the
    evaluation); the ode-rnn split run at 0.5, its epoch_001 equal to the
    continuous run's bit for bit; then 3 fresh and 3 carried
    make_train_step steps each of ode-rnn and rde at B=16. Returns the
    launches by path."""
    cfg = train_config()
    flags = [*train_cli_flags(root, work / "train_carry_cde", dev, 1, "cde"),
             "--carry_exposure", "0.2"]
    steps, evals = train_cli_counts(flags, (0,))
    cde, cde_s, n_cde = run_train_cli("train_carry_cde", ["--experiment_name", "cde", *flags],
                                      steps, evals, 0, 1)
    save = work / "train_carry"
    split_flags = [*train_cli_flags(root, save, dev, 2), "--carry_exposure", "0.5"]
    run = split_run("train_carry_split", split_flags, save, dev, cfg.model.seq_len - 1)
    gaps = run.pop("gaps")
    del run["epoch_001"], run["split_dir"]
    carried = [exposure_draws(split_flags, e, n) for e, n in enumerate(run["steps_by_epoch"])]
    p50, k3_steps = {}, 0
    for mt in ("ode-rnn", "rde"):
        mcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model_type=mt))
        for carry in (False, True):
            name = f"train_carry_{mt.replace('-', '')}_{'carried' if carry else 'fresh'}"
            _, _, _, k3, p50[name] = run_train(name, mcfg, dev, 3, 9, carry=carry)
            k3_steps += k3
            torch.cuda.empty_cache()
    phase("train_carry", cde=epoch_report(cfg, cde), cde_wall_s=cde_s, cde_launches=n_cde,
          cde_carried_by_step=exposure_draws(flags, 0, steps[0]), split_run=run,
          split_carried_by_step=carried, split_vs_continuous_epoch_001=gaps or "bitwise equal",
          p50_step_ms=p50,
          carried_over_fresh={mt: p50[f"train_carry_{mt}_carried"] / p50[f"train_carry_{mt}_fresh"]
                              for mt in ("odernn", "rde")})
    if gaps:
        raise AssertionError(f"train_carry: split run's epoch_001 differs: {gaps}")
    (k3_split_c, k3_split_s), (k1_c, k1_s) = (split_launches(run, k) for k in
                                              ("fused_dropout", "fused_ode_solve"))
    return {"k2": {"train_carry_cde_eval": n_cde["fused_cde_solve"]},
            "k1": {"train_carry_split_eval": k1_c + k1_s},
            "k3": {"train_carry_cde": n_cde["fused_dropout"],
                   "train_carry_split": k3_split_c + k3_split_s, "train_carry_steps": k3_steps}}


# ---------------------------------------------------------------------------
# The rnn, gru, cfc and ltc pose cores
# ---------------------------------------------------------------------------

CORES = {"rnn": dict(model_type="rnn"), "gru": dict(model_type="rnn", ode_rnn_type="gru"),
         "cfc": dict(model_type="cfc"), "ltc": dict(model_type="ltc")}
# per window: sessions to open, sessions to close, sessions served. Session
# 2 closes after its first window and session 4 takes its lane late;
# session 1 idles in window 2
CORE_SCHEDULE = [([0, 1], [], [0, 1]), ([2], [], [0, 1, 2]), ([3], [2], [0, 3]),
                 ([4], [], [0, 1, 3, 4])]
CORE_LANE_ATOL = 1e-5        # an engine lane against its session's own forward
CORE_CPU_ATOL = 1e-4         # the card against the CPU, float32 encoders


def core_config(fields: dict, compute_dtype: str = "bfloat16"):
    cfg = train_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=compute_dtype, **fields))


def serve_cores(engine: StreamingEngine, wins) -> tuple:
    """CORE_SCHEDULE on ``engine``: ({session: [poses a served window]},
    step seconds, (K1, K2) launches)."""
    sids, nxt, out, lat = {}, {s: 0 for s in wins}, {}, []
    n0 = (cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_cde_solve.launches)
    for opens, closes, served in CORE_SCHEDULE:
        for s in opens:
            sids[s] = engine.open_session()
        for s in closes:
            engine.close_session(sids[s])
        batch = {sids[s]: wins[s][nxt[s]] for s in served}
        t = time.perf_counter()
        res = engine.step(batch)
        lat.append(time.perf_counter() - t)
        for s in served:
            nxt[s] += 1
            out.setdefault(s, []).append(res[sids[s]])
    launches = (cuda_kernels.fused_ode_solve.launches - n0[0],
                cuda_kernels.fused_cde_solve.launches - n0[1])
    return out, lat, launches


def direct_poses(infer, windows) -> list:
    """One session's windows through ``infer`` one after another, its clock
    re-based to its first time as the engine re-bases it."""
    t0, carry, out = windows[0][2][0], None, []
    for imgs, imus, ts in windows:
        batch = (torch.from_numpy(imgs[None]).to(infer.device),
                 torch.from_numpy(imus[None]).to(infer.device),
                 torch.from_numpy((np.asarray(ts, np.float64) - t0).astype(np.float32)[None])
                 .to(infer.device))
        poses, carry = infer(*batch, carry)
        out.append(poses[0].cpu().numpy())
    return out


def core_phase(name: str, fields: dict, dev, work: Path, root) -> dict:
    """One pose core at the flagship's widths: served by StreamingEngine
    (max_sessions 4, fold_bn) on CORE_SCHEDULE in bf16 (timed) and float32
    (every lane against its session's own forward within CORE_LANE_ATOL,
    session 0 against the CPU within CORE_CPU_ATOL); cli.test on one
    sequence; 3 train steps at B=16. K1 and K2 never launch."""
    cfg = core_config(fields)
    wins = make_windows(cfg, np.random.default_rng(SEED), len(CORE_SCHEDULE), sessions=5)
    model = create_model(cfg, seed=SEED, device=dev)
    engine = StreamingEngine(model, max_sessions=SESSIONS, fold_bn=True, device=dev)
    engine.warmup(wins[0][0])
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    _, lat, serve_launches = serve_cores(engine, wins)
    del engine
    cfg32 = core_config(fields, "float32")
    model32 = create_model(cfg32, seed=SEED, device=dev)
    engine = StreamingEngine(model32, max_sessions=SESSIONS, fold_bn=True, device=dev)
    engine.warmup(wins[0][0])
    cuda_kernels.reset_launch_counts()
    lanes, lat32, launches32 = serve_cores(engine, wins)
    infer = make_infer_fn(model32, fold_bn=True, device=dev)
    lane_gap, direct = 0.0, {}
    for s, got in lanes.items():
        direct[s] = direct_poses(infer, wins[s][:len(got)])
        lane_gap = max(lane_gap, max(float(np.abs(a - b).max()) for a, b in zip(got, direct[s])))
    cpu = create_model(cfg32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model32.state_dict().items()})
    t = time.perf_counter()
    cpu_poses = direct_poses(make_infer_fn(cpu, fold_bn=True, device="cpu"), wins[0][:2])
    cpu_s = time.perf_counter() - t
    cpu_gap = max(float(np.abs(a - b).max()) for a, b in zip(cpu_poses, direct[0]))
    del engine, infer, model32, cpu
    cuda_kernels.reset_launch_counts()
    t = time.perf_counter()
    cli_test_main(["--experiment_name", f"core_{name}", "--data_dir", str(root), "--save_dir",
                   str(work / "results"), "--device", str(dev), *model_flags(cfg),
                   "--val_seq", EVAL_SEQS[0], "--seed", str(SEED)])
    cli_s = time.perf_counter() - t
    cli_launches = (cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_cde_solve.launches)
    summary = check_summary(f"cores {name}", work / "results" / f"core_{name}_test" /
                            "summary.txt", EVAL_SEQS[:1])
    _, _, _, k3, train_p50 = run_train(f"cores_train_{name}", cfg, dev, 3, 9)
    out = {"p50_served_window_ms": statistics.median(lat) * 1e3, "step_ms": [x * 1e3 for x in lat],
           "p50_served_window_ms_f32": statistics.median(lat32) * 1e3,
           "lane_vs_direct": lane_gap, "card_vs_cpu": cpu_gap, "cpu_s": cpu_s,
           "carry_lane_axis": model.carry_lane_axis, "cli_test_s": cli_s, "cli_summary": summary,
           "p50_train_step_ms": train_p50, "k3": k3,
           "k1_k2": {"serve": serve_launches, "serve_f32": launches32, "cli_test": cli_launches}}
    if any(n != (0, 0) for n in out["k1_k2"].values()):
        raise AssertionError(f"cores {name}: K1/K2 launched {out['k1_k2']}")
    if not lane_gap <= CORE_LANE_ATOL or not cpu_gap <= CORE_CPU_ATOL:
        raise AssertionError(f"cores {name}: lanes vs direct {lane_gap} (limit "
                             f"{CORE_LANE_ATOL}), card vs CPU {cpu_gap} (limit {CORE_CPU_ATOL})")
    del model
    torch.cuda.empty_cache()
    return out


def cores(dev, work: Path, root) -> dict:
    out = {name: core_phase(name, fields, dev, work, root) for name, fields in CORES.items()}
    phase("cores", lane_atol=CORE_LANE_ATOL, cpu_atol=CORE_CPU_ATOL, **out)
    return {f"cores_train_{name}": r["k3"] for name, r in out.items()}


# ---------------------------------------------------------------------------
# The rest of the solver core: the continuous adjoint, the fixed-step and
# Adams solves
# ---------------------------------------------------------------------------

FIELD_PREFIX = {"ode-rnn": "Pose_net.ode_func.", "cde": "Pose_net.cde_func."}
ADJOINT_COSINE_MIN = 0.99    # ode-rnn's adjoint field gradient against the bounded one
MODE_CPU_ATOL = 1e-4         # fixed-step and Adams poses, the card against the CPU


def mode_config(model_type: str = "ode-rnn", adjoint: bool = False, **model_fields):
    """The flagship's train configuration with ``model_type``'s core, the
    continuous adjoint on or off (``--adjoint``'s fields)."""
    cfg = train_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, model_type=model_type, adjoint=adjoint,
                                       **model_fields),
        solver=dataclasses.replace(cfg.solver,
                                   unroll_mode="adjoint" if adjoint else "bounded"))


def record_grads(state) -> list:
    """Wrap the state's optimizer so that each step's gradients are kept
    by parameter name."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    seen, step = [], opt.step

    def record(grads):
        seen.append({names[id(p)]: g.detach().clone() for p, g in zip(opt.params, grads)})
        step(grads)

    opt.step = record
    return seen


def held_memory(model, batch, seed: int) -> dict:
    """What one train-mode pose-core forward keeps for its backward (the
    visual features computed without a graph, as the frozen encoder's are)
    and the backward's peak above the memory before the forward, in GiB."""
    img, imu, _, ts = batch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        fv = model.Image_net(img, gen)
    gc.collect()  # what earlier steps' reference cycles still hold is not this forward's
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    poses = model.pose_from_visual(fv, imu, ts, generator=gen)[0]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    poses.square().sum().backward()
    torch.cuda.synchronize()
    backward_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    model.zero_grad(set_to_none=True)
    return {"held_gib": held / 2 ** 30, "backward_peak_gib": peak / 2 ** 30,
            "backward_ms": backward_s * 1e3}


def mode_epochs(name: str, model_type: str, dev, work: Path, root) -> dict:
    """One cli.train epoch with --adjoint and the same epoch without it
    (``model_type``'s core at the flagship's train configuration): K3 9 a
    step, K1 (ode-rnn) or K2 (cde) only in the evaluation; each step's
    peak memory and that peak above the memory allocated when the step
    began, the backward solves the adjoint truncated."""
    from ode_vio_tpu_torch.cli import train as train_module

    cfg = train_config()
    per_eval = (cfg.model.seq_len - 1, 0) if model_type == "ode-rnn" else (0, 1)
    out = {}
    for adjoint in (True, False):
        key = "adjoint" if adjoint else "bounded"
        flags = [*train_cli_flags(root, work / name, dev, 1, model_type),
                 *(["--adjoint"] if adjoint else [])]
        steps, evals = train_cli_counts(flags, (0,))
        log, factory = [], train_module.make_train_step
        train_module.make_train_step = recording_factory(factory, log)
        truncated = odeint.adjoint_incomplete
        gc.collect()  # what earlier runs' reference cycles still hold is not this run's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            timing, wall, n = run_train_cli(f"{name}_{key}", ["--experiment_name", key, *flags],
                                            steps, evals, *per_eval)
        finally:
            train_module.make_train_step = factory
        peaks = [r["peak_gib"] for r in log]
        out[key] = {**epoch_report(cfg, timing)[0], "wall_s": wall, "launches": n,
                    "eval_windows": evals[0], "peak_gib_by_step": peaks,
                    "peak_step_gib": max(peaks),
                    "over_base_gib_by_step": [r["over_base_gib"] for r in log],
                    "peak_run_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                    "adjoint_backward_rows_truncated": odeint.adjoint_incomplete - truncated}
        torch.cuda.empty_cache()
    return out


def adjoint_gradients(model_type: str, dev) -> dict:
    """One make_train_step batch at B=16 (float32 encoders), through the
    adjoint and through the bounded solve from the same init, batch and
    generator: the pose core's field gradients compared (cosine, largest
    difference over the bounded gradient's largest entry), each step's time,
    peak memory and that peak above the memory allocated before it, and the
    memory a pose-core forward holds for its backward."""
    batch = train_batches(mode_config(model_type), 1, dev, SEED)[0]
    grads, steps = {}, {}
    for adjoint in (False, True):
        cfg = mode_config(model_type, adjoint, compute_dtype="float32")
        state = create_train_state(cfg, create_model(cfg, seed=SEED, device=dev, train=True),
                                   device=dev)
        seen = record_grads(state)
        step = make_train_step(cfg, device=dev)
        truncated = odeint.adjoint_incomplete
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        t = time.perf_counter()
        state, m = step(state, *batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        key = "adjoint" if adjoint else "bounded"
        peak = torch.cuda.max_memory_allocated(dev)
        steps[key] = {"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                      "peak_gib": peak / 2 ** 30, "over_base_gib": (peak - base) / 2 ** 30,
                      "k3": cuda_kernels.fused_dropout.launches,
                      "k1_k2": [cuda_kernels.fused_ode_solve.launches,
                                cuda_kernels.fused_cde_solve.launches],
                      "adjoint_backward_rows_truncated": odeint.adjoint_incomplete - truncated,
                      **held_memory(state.model, batch, SEED)}
        grads[key] = torch.cat([g.flatten() for k, g in seen[0].items()
                                if k.startswith(FIELD_PREFIX[model_type])]).double()
        if not math.isfinite(loss):
            raise AssertionError(f"solver_modes {model_type} {key}: loss {loss}")
        check_launches(f"solver_modes {model_type} {key} K3", steps[key]["k3"], 9)
        check_launches(f"solver_modes {model_type} {key} K1 + K2", sum(steps[key]["k1_k2"]), 0)
        del state, step
        torch.cuda.empty_cache()
    a, b = grads["adjoint"], grads["bounded"]
    cosine = float(a @ b / (a.norm() * b.norm()))
    return {"cosine": cosine, "max_diff_over_max": float((a - b).abs().max() / b.abs().max()),
            "norm_ratio": float(a.norm() / b.norm()), "steps": steps}


def fixed_and_adams(dev, work: Path, root) -> dict:
    """cli.test on sequence 05 with --ode_fixed_step (ode-rnn) and with
    --model_type cde --cde_solver implicit_adams: no K1 and no K2 launch,
    finite metrics; the first two windows card against CPU (float32
    encoders; cde on windows x0.1, as core_cde); one window served through
    StreamingEngine, again with no K1 and no K2."""
    base = eval_config()
    out = {}
    for name, extra in (("fixed_step", ["--ode_fixed_step"]),
                        ("implicit_adams", ["--model_type", "cde",
                                            "--cde_solver", "implicit_adams"])):
        flags = ["--data_dir", str(root), "--save_dir", str(work / "results"),
                 *model_flags(base), *extra, "--val_seq", EVAL_SEQS[0], "--seed", str(SEED)]
        cfg = config_from_args(build_parser().parse_args(flags))
        solver = cfg.cde_solver_cfg if cfg.model.model_type == "cde" else cfg.solver
        if odeint.SolverOptions.from_config(solver).adaptive:
            raise AssertionError(f"solver_modes {name}: the flags build an adaptive solve")
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        t = time.perf_counter()
        cli_test_main(["--experiment_name", f"modes_{name}", "--device", str(dev), *flags])
        cli_s = time.perf_counter() - t
        cli_launches = [cuda_kernels.fused_ode_solve.launches,
                        cuda_kernels.fused_cde_solve.launches]
        summary = check_summary(f"solver_modes {name}", work / "results" /
                                f"modes_{name}_test" / "summary.txt", EVAL_SEQS[:1])
        cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                   compute_dtype="float32"))
        wins = make_windows(cfg32, np.random.default_rng(SEED), 2, sessions=1)
        if cfg.model.model_type == "cde":
            wins = scaled(wins, CDE_CORE_SCALE)
        model = create_model(cfg32, seed=SEED, device=dev)
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        card = direct_poses(make_infer_fn(model, fold_bn=True, device=dev), wins[0])
        engine = StreamingEngine(model, max_sessions=SESSIONS, fold_bn=True, device=dev)
        sid = engine.open_session()
        t = time.perf_counter()
        served = engine.step({sid: wins[0][0]})[sid]
        served_ms = (time.perf_counter() - t) * 1e3
        launches = [cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_cde_solve.launches]
        cpu = create_model(cfg32, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu_poses = direct_poses(make_infer_fn(cpu, fold_bn=True, device="cpu"), wins[0])
        gap = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu_poses))
        out[name] = {"model_type": cfg.model.model_type, "method": solver.method,
                     "fixed_steps": solver.fixed_steps, "cli_test_s": cli_s,
                     "cli_summary": summary, "cli_k1_k2": cli_launches,
                     "direct_and_served_k1_k2": launches, "card_vs_cpu": gap,
                     "served_window_ms": served_ms,
                     "served_vs_direct": float(np.abs(served - card[0]).max()),
                     "median_abs_pose": float(np.median(np.abs(np.stack(card))))}
        check_launches(f"solver_modes {name} K1 + K2", sum(cli_launches) + sum(launches), 0)
        if not gap <= MODE_CPU_ATOL or not np.isfinite(served).all():
            raise AssertionError(f"solver_modes {name}: card vs CPU {gap} (limit "
                                 f"{MODE_CPU_ATOL}), served {served}")
        del engine, model, cpu
        torch.cuda.empty_cache()
    return out


def solver_modes(dev, work: Path, root) -> dict:
    """The continuous adjoint (ode-rnn and cde cli.train epochs against the
    bounded ones, gradients against the bounded ones), the fixed-step and
    Adams evaluations. Returns the launches by path."""
    t = time.perf_counter()
    epochs = {mt: mode_epochs(f"modes_{mt.replace('-', '')}", mt, dev, work, root)
              for mt in ("ode-rnn", "cde")}
    epochs_s = time.perf_counter() - t
    grads = {mt: adjoint_gradients(mt, dev) for mt in ("ode-rnn", "cde")}
    fixed = fixed_and_adams(dev, work, root)
    phase("solver_modes", epochs=epochs, epochs_s=epochs_s, gradients=grads,
          cosine_min_odernn=ADJOINT_COSINE_MIN, fixed_and_adams=fixed, cpu_atol=MODE_CPU_ATOL)
    if not grads["ode-rnn"]["cosine"] >= ADJOINT_COSINE_MIN:
        raise AssertionError(f"solver_modes: ode-rnn adjoint gradient cosine "
                             f"{grads['ode-rnn']['cosine']} (< {ADJOINT_COSINE_MIN})")
    n = {f"{mt}_{key}": r["launches"] for mt, e in epochs.items() for key, r in e.items()}
    return {"k1": {f"solver_modes_{k}_eval": v["fused_ode_solve"] for k, v in n.items()
                   if k.startswith("ode-rnn")} | {
                f"solver_modes_{k}": v["cli_k1_k2"][0] + v["direct_and_served_k1_k2"][0]
                for k, v in fixed.items()},
            "k2": {f"solver_modes_{k}_eval": v["fused_cde_solve"] for k, v in n.items()
                   if k.startswith("cde")} | {
                f"solver_modes_{k}": v["cli_k1_k2"][1] + v["direct_and_served_k1_k2"][1]
                for k, v in fixed.items()},
            "k3": {**{f"solver_modes_{k}": v["fused_dropout"] for k, v in n.items()},
                   "solver_modes_gradients": sum(s["k3"] for g in grads.values()
                                                 for s in g["steps"].values())}}


# ---------------------------------------------------------------------------
# The s2d and int8 encoders
# ---------------------------------------------------------------------------

INT8_OPS = 1979e12           # H100 SXM dense int8 tensor-core peak (data sheet)
ENCODER_LANES = 4            # 4 lanes of one window (10 frame pairs), 256x512, bf16
INT8_FLOAT_CORR_MIN = 0.99   # int8 against float features: JAX's bound (test_quant.py)
# s2d and direct trunks in bf16 round their convs' sums apart: the largest
# feature gap over the largest feature, as the bf16 encoders are held (2e-2)
S2D_FEATURE_RTOL = 2e-2


def image_net(sd: dict, dev, **model_fields) -> ImageEncoder:
    """The flagship's image encoder with ``model_fields`` in eval mode on
    the card, loaded from the Image_net entries of ``sd``."""
    cfg = dataclasses.replace(eval_config().model, **model_fields)
    net = ImageEncoder(cfg).to(dev).eval()
    net.load_state_dict({k[len("Image_net."):]: v for k, v in sd.items()
                         if k.startswith("Image_net.")})
    return net


def trunk_inputs(net, img) -> list:
    """Each trunk block's input in ``net``'s forward of ``img``."""
    seen = []
    hooks = [getattr(net, name).register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
             for name in TRUNK_NAMES]
    try:
        with torch.no_grad():
            net(img)
    finally:
        for h in hooks:
            h.remove()
    return seen


def int8_gemm_bound(a, b, xq) -> dict:
    """The least time of one int8 conv's GEMM: 2 ops a product over the
    int8 tensor-core peak, or its int8 input and kernel read once and its
    int32 sums written once over the HBM rate."""
    M, K = a.shape
    ops = 2 * M * K * b.shape[0]
    nbytes = xq.numel() + b.numel() + 4 * M * b.shape[0]
    t = {"ops_ms": ops / INT8_OPS * 1e3, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": max(t.values()),
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"}


@torch.no_grad()
def int8_convs(q, img) -> list:
    """Each of the int8 trunk's nine convs on its own input of ``q``'s
    forward of ``img``: the card's int32 sums against the plain version's
    (bit for bit), and CUDA-event times of the route (im2col + GEMM), the
    GEMM alone, the whole int8 conv and the cuDNN bf16 conv of the layer."""
    rows = []
    for name, x, (_, k, stride, _) in zip(TRUNK_NAMES, trunk_inputs(q, img), TRUNK):
        pad = (k - 1) // 2
        w = getattr(q, name)[0].weight
        kq, _ = encoders.quantize_weight(w.float())
        xq, _ = encoders.quantize_activation(x)
        acc = encoders.int8_accumulate(xq, kq, stride, pad)
        plain = encoders.int8_accumulate_plain(xq, kq, stride, pad)
        torch.cuda.synchronize()
        equal = torch.equal(acc, plain)
        a, b, _ = encoders.int8_gemm_operands(xq, kq, stride, pad)
        w16 = w.to(torch.bfloat16)
        rows.append({"conv": name, "input": list(x.shape), "equal": equal,
                     "max_abs_acc": int(plain.abs().max()), "gemm_mkn": [*a.shape, b.shape[0]],
                     "route_ms": cuda_ms(lambda: encoders.int8_accumulate(xq, kq, stride, pad)),
                     "gemm_ms": cuda_ms(lambda: torch._int_mm(a, b.t())),
                     "int8_conv_ms": cuda_ms(lambda: encoders.int8_conv(x, w, stride, pad, True)),
                     "cudnn_bf16_ms": cuda_ms(lambda: F.conv2d(x, w16, stride=stride,
                                                               padding=pad)),
                     **int8_gemm_bound(a, b, xq)})
        if not equal:
            raise AssertionError(f"encoders: {name}'s int8 sums differ from the plain version's "
                                 f"(largest gap {int((acc - plain).abs().max())})")
        del acc, plain, a, b
    return rows


def encoders_cli(dev, work: Path, root, pth: Path) -> dict:
    """cli.test on sequence 05, float and --encoder_int8, from the flagship
    .pth: finite metrics; K1 10 launches a window in both, the int8 GEMM 9
    a window with --encoder_int8 and none without."""
    cfg = eval_config()
    windows = len(EvalPartition(root, EVAL_SEQS[0], cfg.model.seq_len))
    common = ["--data_dir", str(root), "--save_dir", str(work / "results"), "--device", str(dev),
              "--pretrain", str(pth), *model_flags(cfg), "--val_seq", EVAL_SEQS[0],
              "--seed", str(SEED)]
    out = {}
    for name, extra, gemms in (("float", [], 0), ("int8", ["--encoder_int8"], 9 * windows)):
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        encoders.int8_accumulate.launches = 0
        t = time.perf_counter()
        cli_test_main(["--experiment_name", f"encoders_{name}", *common, *extra])
        wall = time.perf_counter() - t
        k1, n = cuda_kernels.fused_ode_solve.launches, encoders.int8_accumulate.launches
        check_launches(f"encoders cli.test {name} K1", k1, (cfg.model.seq_len - 1) * windows)
        check_launches(f"encoders cli.test {name} int8 GEMM", n, gemms)
        out[name] = {"wall_s": wall, "k1_launches": k1, "int8_gemm_launches": n,
                     "summary": check_summary(f"encoders {name}", work / "results" /
                                              f"encoders_{name}_test" / "summary.txt",
                                              EVAL_SEQS[:1])[EVAL_SEQS[0]]}
    return out


def encoders_phase(dev, work: Path, root, pth: Path) -> dict:
    """The int8 and s2d encoders at the flagship's width (4 lanes of 10
    frame pairs, 256x512, bf16, seed-0 weights): the nine int8 convs' sums
    against the plain version and their times beside cuDNN's bf16 convs;
    int8 features against the float ones; the trunk int8 against bf16 as
    eval runs them; cli.test --encoder_int8; s2d's trunk against the
    direct convs, conv1/conv2 timed both ways, and one train step through
    s2d (K3 9 launches). Returns the launches by path."""
    cfg = eval_config()
    m = cfg.model
    sd = create_model(cfg, seed=SEED, device=dev).state_dict()
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    img = torch.rand((ENCODER_LANES, m.seq_len, m.img_h, m.img_w, 3), generator=gen,
                     device=dev) - 0.5
    q = image_net(fold_batchnorm(sd), dev, encoder_int8=True)    # as eval runs int8
    bf16 = image_net(fold_batchnorm_into_bias(sd), dev, skip_bn=True)  # as eval runs bf16
    convs = int8_convs(q, img)
    with torch.no_grad():
        fq, ff = q(img), bf16(img)
        trunk = {"int8_ms": cuda_ms(lambda: q(img), runs=10),
                 "bf16_ms": cuda_ms(lambda: bf16(img), runs=10)}
    corr = float(np.corrcoef(fq.cpu().numpy().ravel(), ff.cpu().numpy().ravel())[0, 1])
    del q, bf16
    cli = encoders_cli(dev, work, root, pth)

    direct, s2d = image_net(sd, dev), image_net(sd, dev, encoder_s2d=True)
    s2d_convs = []
    with torch.no_grad():
        fd, fs = direct(img), s2d(img)
        for name, x in zip(TRUNK_NAMES[:2], trunk_inputs(direct, img)[:2]):
            w = getattr(direct, name)[0].weight.to(torch.bfloat16)
            pad = (w.shape[-1] - 1) // 2
            s2d_convs.append({"conv": name, "input": list(x.shape),
                              "direct_ms": cuda_ms(lambda: F.conv2d(x, w, stride=2, padding=pad)),
                              "s2d_ms": cuda_ms(lambda: encoders.s2d_conv(x, w))})
        trunk.update(direct_ms=cuda_ms(lambda: direct(img), runs=10),
                     s2d_ms=cuda_ms(lambda: s2d(img), runs=10))
    s2d_gap = float((fs - fd).abs().max() / fd.abs().max())
    del direct, s2d, fd, fs
    torch.cuda.empty_cache()

    tcfg = train_config()
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, encoder_s2d=True))
    state = create_train_state(tcfg, create_model(tcfg, seed=SEED, device=dev, train=True),
                               device=dev)
    step = make_train_step(tcfg, device=dev)
    batch = train_batches(tcfg, 1, dev, SEED)[0]
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    t = time.perf_counter()
    state, metrics = step(state, *batch)
    loss = float(metrics["loss"])
    step_ms = (time.perf_counter() - t) * 1e3
    k3 = cuda_kernels.fused_dropout.launches
    phase("encoders", lanes=ENCODER_LANES, frame_pairs=ENCODER_LANES * (m.seq_len - 1),
          int8_convs=convs, int8_all_equal=all(c["equal"] for c in convs),
          int8_sums={k: sum(c[k] for c in convs) for k in
                     ("route_ms", "gemm_ms", "int8_conv_ms", "cudnn_bf16_ms", "bound_ms")},
          int8_vs_float_corr=corr, corr_min=INT8_FLOAT_CORR_MIN, trunk=trunk, cli_test=cli,
          s2d_feature_gap=s2d_gap, s2d_rtol=S2D_FEATURE_RTOL, s2d_convs=s2d_convs,
          s2d_train={"batch": tcfg.train.batch_size, "loss": loss, "step_ms": step_ms,
                     "k3_launches": k3})
    check_launches("encoders s2d train step K3", k3, 9)
    if not corr > INT8_FLOAT_CORR_MIN:
        raise AssertionError(f"encoders: int8 vs float feature correlation {corr}")
    if not s2d_gap <= S2D_FEATURE_RTOL:
        raise AssertionError(f"encoders: s2d trunk {s2d_gap} of the direct one's largest "
                             f"feature (limit {S2D_FEATURE_RTOL})")
    if not math.isfinite(loss):
        raise AssertionError(f"encoders: s2d train step loss {loss}")
    del state, step, batch
    torch.cuda.empty_cache()
    return {"k1": {f"encoders_cli_{k}": v["k1_launches"] for k, v in cli.items()},
            "k3": {"encoders_s2d_train": k3}}


# ---------------------------------------------------------------------------
# The single-card edges: export, parity, profiling, the NaN trap
# ---------------------------------------------------------------------------

# cuDNN's convolution kernels on Hopper, by the words their names carry
CONV_KERNEL = re.compile(r"conv|fprop|dgrad|wgrad|xmma|implicit_gemm|cudnn|cutlass|winograd",
                         re.IGNORECASE)


def recorded_cli_test(argv: list) -> list:
    """cli.test ``argv`` with the poses of every call of its inference
    callable recorded (on the CPU)."""
    log, real = [], cli_test_module.make_infer_fn

    def factory(*args, **kwargs):
        infer = real(*args, **kwargs)

        def rec(img, imu, ts, carry=None, active=None):
            poses, carry = infer(img, imu, ts, carry, active)
            log.append(poses.cpu())
            return poses, carry

        for attr in ("incomplete", "incomplete_by_lane", "reset_incomplete", "set_variables",
                     "device"):
            setattr(rec, attr, getattr(infer, attr))
        return rec

    cli_test_module.make_infer_fn = factory
    try:
        cli_test_main(argv)
    finally:
        cli_test_module.make_infer_fn = real
    return log


def export_checks(dev, work: Path, root, ckpt: Path) -> dict:
    """cli.export of train_cli's checkpoints directory to .pth and .npz:
    the checkpoint's model state without num_batches_tracked, bit for bit;
    cli.test on sequence 05 from the .pth and from the directory: poses
    equal bit for bit (K1 10 a window each)."""
    cfg = train_config()
    flags = [*model_flags(cfg), "--device", str(dev)]
    want = {k: v for k, v in CheckpointManager(ckpt).restore_raw("epoch_001")["model"].items()
            if not k.endswith("num_batches_tracked")}
    files = {}
    for suffix in ("pth", "npz"):
        out = work / f"edges.{suffix}"
        t = time.perf_counter()
        export_main([*flags, "--pretrain", str(ckpt), "--out", str(out)])
        got = load_reference_file(out)
        gaps = tensor_gaps(want, got) if got.keys() == want.keys() else {"keys": "differ"}
        files[suffix] = {"s": time.perf_counter() - t, "bytes": out.stat().st_size,
                         "tensors": len(got), "gaps": gaps or "bitwise equal"}
        if gaps:
            raise AssertionError(f"edges: the .{suffix} export differs: {gaps}")
    windows = len(EvalPartition(root, EVAL_SEQS[0], cfg.model.seq_len))
    poses, k1 = {}, {}
    for name, pretrain in (("pth", work / "edges.pth"), ("dir", ckpt)):
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        poses[name] = recorded_cli_test([
            "--experiment_name", f"edges_{name}", "--data_dir", str(root),
            "--save_dir", str(work / "results"), "--pretrain", str(pretrain), *flags,
            "--val_seq", EVAL_SEQS[0], "--seed", str(SEED)])
        k1[f"edges_cli_test_{name}"] = cuda_kernels.fused_ode_solve.launches
        check_launches(f"edges cli.test {name} K1", k1[f"edges_cli_test_{name}"],
                       (cfg.model.seq_len - 1) * windows)
    equal = len(poses["pth"]) == len(poses["dir"]) == windows and all(
        torch.equal(a, b) for a, b in zip(poses["pth"], poses["dir"]))
    if not equal or not all(torch.isfinite(p).all() for p in poses["pth"]):
        raise AssertionError("edges: cli.test from the .pth and from the directory differ")
    return {"files": files, "cli_test_windows": windows, "pth_vs_dir_poses": "bitwise equal",
            "k1": k1}


def parity_check(dev, work: Path, root) -> dict:
    """cli.parity --torch_protocol of the exported .pth on the three
    sequences: its report (the port's tester in bf16, the reference
    replica in float32), K1 10 a window of the port's side."""
    cfg = train_config()
    buf = io.StringIO()
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = parity_main(["--data_dir", str(root), "--save_dir", str(work / "results"),
                          *model_flags(cfg), "--device", str(dev), "--val_seq", *EVAL_SEQS,
                          "--seed", str(SEED), "--ref_ckpt", str(work / "edges.pth"),
                          "--torch_protocol"])
    wall = time.perf_counter() - t
    k1 = cuda_kernels.fused_ode_solve.launches
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    # the port's tester runs the three sequences as lanes: one launch a window step
    steps = max(len(EvalPartition(root, s, cfg.model.seq_len)) for s in EVAL_SEQS)
    check_launches("edges parity K1", k1, (cfg.model.seq_len - 1) * steps)
    rows = report["rows"]
    if rc != 0 or report["ref_source"] != "torch_protocol" or [r["seq"] for r in rows] != list(
            EVAL_SEQS) or not all(math.isfinite(r[side][k]) for r in rows
                                  for side in ("ours", "ref") for k in METRICS):
        raise AssertionError(f"edges: cli.parity rc {rc}, report {report}")
    return {"wall_s": wall, "rows": rows, "worst_delta_pct": report["worst_delta_pct"],
            "k1": k1}


def profile_check(dev, work: Path, root) -> dict:
    """One cli.train epoch (8 steps, B=16) with --profile_dir: the trace of
    steps 1-4 holds CUDA kernel events, K3's and the convolutions'."""
    cfg = train_config()
    flags = train_cli_flags(root, work / "edges_train", dev, epochs=1)
    steps, evals = train_cli_counts(flags, (0,))
    if steps[0] < 5:
        raise AssertionError(f"edges: the profiled epoch has {steps[0]} steps (< 5)")
    prof = work / "profile"
    timing, wall, got = run_train_cli("edges_profile", [
        "--experiment_name", "profiled", *flags, "--profile_dir", str(prof)],
        steps, evals, cfg.model.seq_len - 1, 0)
    (path,) = list(prof.glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k3_events = sum("fused_dropout" in n for n in kernels)
    conv_events = sum(bool(CONV_KERNEL.search(n)) for n in kernels)
    busy_ms = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3
    out = {"steps": steps[0], "epoch": epoch_report(cfg, timing), "wall_s": wall,
           "trace_bytes": path.stat().st_size, "events": len(events),
           "kernel_events": len(kernels), "k3_kernel_events": k3_events,
           "conv_kernel_events": conv_events, "kernel_busy_ms": busy_ms,
           "launches": got}
    if k3_events != 9 * 4 or not conv_events:
        raise AssertionError(f"edges: the trace holds {len(kernels)} kernel events, K3 "
                             f"{k3_events} (expected 36 for steps 1-4), convolutions "
                             f"{conv_events}")
    return out


def nan_check(dev) -> dict:
    """A flagship window with a NaN in one IMU sample through
    make_infer_fn on the card: without --debug_nans it runs (the poses
    hold NaN); with the flag it raises FloatingPointError."""
    cfg = eval_config()
    m = cfg.model
    model = create_model(cfg, seed=SEED, device=dev)
    infer = make_infer_fn(model, fold_bn=True, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    img = torch.rand((1, m.seq_len, m.img_h, m.img_w, 3), generator=gen, device=dev) - 0.5
    imu = torch.randn((1, 10 * (m.seq_len - 1) + 1, 6), generator=gen, device=dev)
    ts = torch.cumsum(0.08 + 0.05 * torch.rand((1, m.seq_len), generator=gen, device=dev), 1)
    imu[0, 17, 4] = float("nan")
    poses, _ = infer(img, imu, ts)
    off = {"raised": False, "poses_finite": bool(torch.isfinite(poses).all())}
    try:
        config_from_args(build_parser().parse_args(["--debug_nans"]))
        infer(img, imu, ts)
        on = {"raised": False}
    except FloatingPointError as e:
        on = {"raised": True, "message": str(e)}
    finally:
        profiling.set_debug_nans(False)
    if not on["raised"]:
        raise AssertionError("edges: --debug_nans did not raise on a NaN IMU sample")
    return {"without_flag": off, "with_flag": on}


def edges(dev, work: Path, root) -> dict:
    """cli.export, cli.parity, --profile_dir, --debug_nans, analyse_flops
    and device_memory_stats on the card, from train_cli's checkpoints
    directory (2 epochs of the flagship). Returns the launches by path."""
    ckpt = work / "train_cli" / "cont" / "checkpoints"
    exported = export_checks(dev, work, root, ckpt)
    parity = parity_check(dev, work, root)
    profiled = profile_check(dev, work, root)
    nans = nan_check(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    flops = analyse_flops(eval_config(), batch_size=1, device=dev)
    stats = profiling.device_memory_stats(dev)
    memory = {k: stats[k] for k in ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                                    "reserved_bytes.all.peak", "num_alloc_retries")}
    phase("edges", export=exported, parity=parity, profile=profiled, debug_nans=nans,
          analyse_flops={"flops": flops["flops"], "by_op": flops["by_op"]},
          device_memory_stats=memory)
    launches = profiled["launches"]
    return {"k1": {**exported["k1"], "edges_parity": parity["k1"],
                   "edges_profile_eval": launches["fused_ode_solve"]},
            "k3": {"edges_profile": launches["fused_dropout"]}}


# -- mesh: data-parallel ranks and replicas ----------------------------------
# The machine has one card: two ranks share cuda:0 over gloo (NCCL refuses
# two ranks on one device), and the eval and serving replicas both sit on it.
MESH_RANKS = 2
MESH_STEPS = 3
MESH_RUN_TIMES = 2           # eval_mesh: 3 sequences x 2 runs = 6 lanes
# the 2-rank step against the one-process step at B=16 in float32 (PERF.md
# section 2's card-against-CPU bound: cuDNN may pick other algorithms at B=8)
MESH_STEP_RTOL = 1e-4
# a split lane against the unsplit one: the batched-eval bound (bf16) and
# float32's
MESH_POSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-5}
ALLREDUCE_REPS = 5


def state_digest(state) -> str:
    """SHA-256 of a train state's model, optimizer, step and generator."""
    import hashlib

    h = hashlib.sha256()
    tensors = list(state.model.state_dict().values())
    for st in state.optimizer.inner.state.values():
        tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    tensors += state.optimizer._mean or []
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    h.update(state.generator.get_state().numpy().tobytes())
    h.update(np.int64([state.step, state.optimizer.mini_step]).tobytes())
    return h.hexdigest()


def without_trunk_dropout(model):
    """``model`` with its image trunk's dropout rates 0 (the same weights)."""
    trunk0 = tuple((f, k, s, 0.0) for f, k, s, _ in TRUNK)
    net = ImageEncoder(model.cfg, trunk0)
    net.load_state_dict(model.Image_net.state_dict())
    model.Image_net = net.to(next(model.parameters()).device).train(model.training)
    return model


def float32_step_config(cfg):
    """``cfg`` in float32 without weight decay: where a (clipped) gradient
    is the size of the decay term their sum is rounding, and Adam steps it
    by +-lr either way (the CPU tests' trunk case drops it too)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                               train=dataclasses.replace(cfg.train, weight_decay=0.0))


def mesh_parity_state(cfg, dev, mesh=None):
    """The float32 parity step's state: seed-0 weights, no trunk dropout."""
    cfg32 = float32_step_config(cfg)
    model = without_trunk_dropout(create_model(cfg32, seed=SEED, device=dev, train=True))
    return cfg32, create_train_state(cfg32, model, device=dev, mesh=mesh)


def train_mesh_rank(dev, cfg, steps: int) -> dict:
    """One rank of train_mesh: ``steps`` steps of ``cfg`` at its rows of
    seeded global batches (the counts set to 0 just before, read just
    after), a digest of the state after each, the first key it mixes, the
    peak memory, the time of the gradient's all-reduce alone; then one
    float32 step without dropout, whose trained tensors rank 0 returns."""
    from ode_vio_tpu_torch.models.common import RankKeys, draw_key
    from ode_vio_tpu_torch.parallel.mesh import create_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = torch.distributed.get_rank()
    mesh = create_mesh(MESH_RANKS, 1)
    state = create_train_state(cfg, create_model(cfg, seed=SEED, device=dev, train=True),
                               device=dev, mesh=mesh)
    step = make_train_step(cfg, device=dev, mesh=mesh)
    batches = [shard_batch(mesh, b) for b in train_batches(cfg, steps, dev, SEED)]
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    key = draw_key(RankKeys(gen, mesh.coords["data"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    rows = []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, *b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                     "grad_norm": float(m["grad_norm"]), "digest": state_digest(state)})
    launches = {k: getattr(cuda_kernels, k).launches
                for k in ("fused_dropout", "fused_ode_solve", "fused_cde_solve")}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    flat = torch.zeros(sum(p.numel() for p in state.optimizer.params), device=dev)
    group = mesh.groups["data"]
    times = []
    for _ in range(ALLREDUCE_REPS):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.distributed.all_reduce(flat, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    del state, step
    torch.cuda.empty_cache()
    cfg32, state32 = mesh_parity_state(cfg, dev, mesh)
    batch = shard_batch(mesh, train_batches(cfg32, 1, dev, SEED + 1)[0])
    _, m = make_train_step(cfg32, device=dev, mesh=mesh)(state32, *batch)
    out = {"rank": rank, "rows_of_batch": mesh.coords["data"], "steps": rows, "key": key,
           "launches": launches, "peak_memory_gib": peak, "allreduce_ms": times,
           "allreduce_bytes": flat.numel() * flat.element_size(),
           "parity_loss": float(m["loss"]), "parity_grad_norm": float(m["grad_norm"]),
           "parity_digest": state_digest(state32)}
    if rank == 0:
        out["parity_state"] = trained_tensors(state32)
    return out


def trained_tensors(state) -> dict:
    """The tensors a step moves: the optimizer's parameters and every
    BatchNorm statistic, on the CPU."""
    trained = {id(p) for p in state.optimizer.params}
    names = {n for n, p in state.model.named_parameters() if id(p) in trained}
    return {k: v.detach().cpu() for k, v in state.model.state_dict().items()
            if k in names or "running" in k}


def clear_gaps(got: dict, want: dict, grads: dict, rtol: float) -> dict:
    """{name: worst |got - want| over rtol * |want| + 1e-6} where the
    gradient clears rounding (exactly 0, or above 1e-3 of its tensor's
    largest in tensors whose largest is above 1e-5 of the step's; the
    CPU tests' rule: Adam steps a rounding-noise gradient by +-lr either
    way), and over every running statistic; a value above 1 fails."""
    top = max(float(g.abs().max()) for g in grads.values())
    out = {}
    for name, x in got.items():
        ref = want[name].cpu()
        mask = torch.ones(x.shape, dtype=torch.bool)
        if name in grads:
            g = grads[name].cpu()
            big = float(g.abs().max())
            mask = ((g == 0) | (g.abs() > 1e-3 * big)) & (big > 1e-5 * top)
        if mask.any():
            out[name] = float(((x - ref).abs() / (rtol * ref.abs() + 1e-6))[mask].max())
    return out


def train_mesh(dev, cfg, steps: int, k3_per_step: int) -> dict:
    """``cfg``'s train step on MESH_RANKS ranks sharing ``dev`` over gloo
    (parallel/mesh.py::launch), each on its rows of the seeded global
    batches: K3 ``k3_per_step`` a step on every rank, the ranks' states
    equal bit for bit after every step, their keys different; the float32
    step without dropout against one process's at the global batch (loss,
    global gradient norm and trained tensors within MESH_STEP_RTOL where
    the gradient clears rounding). Returns K3's launches on all ranks and the report."""
    from ode_vio_tpu_torch.parallel.mesh import launch

    t = time.perf_counter()
    ranks = launch(train_mesh_rank, [dev] * MESH_RANKS, cfg, steps, backend="gloo")
    wall = time.perf_counter() - t
    for r in ranks:
        want = {"fused_dropout": k3_per_step * steps, "fused_ode_solve": 0, "fused_cde_solve": 0}
        if r["launches"] != want:
            raise AssertionError(f"train_mesh rank {r['rank']}: launches {r['launches']}, "
                                 f"expected {want}")
        if not all(math.isfinite(x["loss"]) for x in r["steps"]):
            raise AssertionError(f"train_mesh rank {r['rank']}: losses {r['steps']}")
    split_steps = [i for i, (a, b) in enumerate(zip(ranks[0]["steps"], ranks[1]["steps"]))
                   if a["digest"] != b["digest"]]
    if split_steps or ranks[0]["parity_digest"] != ranks[1]["parity_digest"]:
        raise AssertionError(f"train_mesh: the ranks' states differ after steps {split_steps}")
    if ranks[0]["key"] == ranks[1]["key"] or ranks[0]["rows_of_batch"] == ranks[1]["rows_of_batch"]:
        raise AssertionError("train_mesh: the ranks drew one key or took the same rows")
    # the one-process float32 step at the global batch, on the card
    cfg32, state = mesh_parity_state(cfg, dev)
    seen = record_grads(state)
    batch = train_batches(cfg32, 1, dev, SEED + 1)[0]
    _, m = make_train_step(cfg32, device=dev)(state, *batch)
    loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
    gaps = clear_gaps(ranks[0]["parity_state"], trained_tensors(state), seen[0], MESH_STEP_RTOL)
    loss_rel = abs(ranks[0]["parity_loss"] - loss) / abs(loss)
    # Adam is nearly blind to the gradient's scale: the global norm shows
    # that the ranks averaged their gradients over the whole data group
    norm_rel = abs(ranks[0]["parity_grad_norm"] - grad_norm) / abs(grad_norm)
    report = {"ranks": MESH_RANKS, "backend": "gloo", "device": str(dev),
              "global_batch": cfg.train.batch_size, "steps": steps, "wall_s": wall,
              "per_rank": [{"rank": r["rank"], "rows_of_batch": r["rows_of_batch"],
                            "step_ms": [x["ms"] for x in r["steps"]],
                            "p50_step_ms_after_first": statistics.median(
                                x["ms"] for x in r["steps"][1:]),
                            "losses": [x["loss"] for x in r["steps"]],
                            "peak_memory_gib": r["peak_memory_gib"], "key": hex(r["key"]),
                            "launches": r["launches"]} for r in ranks],
              "grad_allreduce": {"backend": "gloo", "bytes": ranks[0]["allreduce_bytes"],
                                 "ms": ranks[0]["allreduce_ms"],
                                 "p50_ms": statistics.median(ranks[0]["allreduce_ms"])},
              "states_bitwise_equal_every_step": True,
              "parity_float32": {"loss_2_ranks": ranks[0]["parity_loss"], "loss_1_process": loss,
                                 "loss_rel": loss_rel,
                                 "grad_norm_2_ranks": ranks[0]["parity_grad_norm"],
                                 "grad_norm_1_process": grad_norm, "grad_norm_rel": norm_rel,
                                 "worst_tensor_gap_over_limit":
                                 max(gaps.values()), "tensors": len(gaps)}}
    if loss_rel > MESH_STEP_RTOL or norm_rel > MESH_STEP_RTOL or max(gaps.values()) > 1.0:
        bad = {k: v for k, v in gaps.items() if v > 1.0}
        raise AssertionError(f"train_mesh: 2 ranks against 1 process: loss rel {loss_rel}, "
                             f"grad_norm rel {norm_rel}, tensors over the limit {bad}")
    del state
    torch.cuda.empty_cache()
    return {"k3": sum(r["launches"]["fused_dropout"] for r in ranks), "report": report}


def train_cli_mesh_rank(dev, flags: list, save: Path) -> dict:
    """One rank of train_cli_mesh: cli.train for two epochs, then (rank 0
    copying the run's epoch_000 as a run stopped there leaves it) a run
    resumed from it for epoch 1, each with the counts set to 0 just before
    and read just after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = torch.distributed.get_rank()
    split = save / "split" / "checkpoints"
    out = {"rank": rank}
    torch.cuda.reset_peak_memory_stats(dev)
    for name, args in (("continuous", ["--experiment_name", "cont", *flags]),
                       ("resume", ["--experiment_name", "split", *flags,
                                   "--pretrain", str(split)])):
        if name == "resume" and rank == 0:
            cont = save / "cont" / "checkpoints"
            shutil.copytree(cont / "epoch_000", split / "epoch_000")
            shutil.copy(cont / "epoch_000.meta.json", split)
        torch.distributed.barrier()
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        timing = {}
        t = time.perf_counter()
        train_main(args, timing=timing)
        out[name] = {"wall_s": time.perf_counter() - t, "epochs": timing["epochs"],
                     "launches": {k: getattr(cuda_kernels, k).launches for k in
                                  ("fused_dropout", "fused_ode_solve", "fused_cde_solve")}}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def train_cli_mesh(dev, work: Path, root) -> dict:
    """cli.train --mesh_data 2 on the flagship's train configuration (B=16
    global, 8 a rank) on the eval tree, its two ranks sharing the card over
    gloo: two epochs, then a run resumed from the first epoch's
    checkpoint, whose epoch_001 must equal the two-epoch run's bit for
    bit. K3 9 a step on each rank, K1 10 a window step of rank 0's
    evaluation and none on rank 1."""
    from ode_vio_tpu_torch.parallel.mesh import launch

    cfg = train_config()
    save = work / "train_cli_mesh"
    flags = [*train_cli_flags(root, save, dev, epochs=2), "--mesh_data", str(MESH_RANKS)]
    steps, evals = train_cli_counts(flags, (0, 1))
    t = time.perf_counter()
    ranks = launch(train_cli_mesh_rank, [dev] * MESH_RANKS, flags, save, backend="gloo")
    wall = time.perf_counter() - t
    k1_per_eval = cfg.model.seq_len - 1
    for r in ranks:
        for name, n_steps, n_evals in (("continuous", steps, evals),
                                       ("resume", steps[1:], evals[1:])):
            got = r[name]["launches"]
            check_launches(f"train_cli_mesh rank {r['rank']} {name} K3", got["fused_dropout"],
                           9 * sum(n_steps))
            check_launches(f"train_cli_mesh rank {r['rank']} {name} K1",
                           got["fused_ode_solve"], k1_per_eval * sum(n_evals) * (r["rank"] == 0))
            check_launches(f"train_cli_mesh rank {r['rank']} {name} K2", got["fused_cde_solve"], 0)
            if [len(e["steps"]) for e in r[name]["epochs"]] != n_steps:
                raise AssertionError(f"train_cli_mesh rank {r['rank']} {name}: steps "
                                     f"{[len(e['steps']) for e in r[name]['epochs']]}")
    a = CheckpointManager(save / "cont" / "checkpoints").restore_raw("epoch_001")
    b = CheckpointManager(save / "split" / "checkpoints").restore_raw("epoch_001")
    gaps = tensor_gaps(a, b)
    per_rank = []
    for r in ranks:
        ms = [s["s"] * 1e3 for e in r["continuous"]["epochs"] for s in e["steps"]][1:]
        per_rank.append({"rank": r["rank"], "p50_step_ms": statistics.median(ms),
                         "peak_memory_gib": r["peak_memory_gib"],
                         "wall_s": {k: r[k]["wall_s"] for k in ("continuous", "resume")},
                         "launches": {k: r[k]["launches"] for k in ("continuous", "resume")},
                         "losses": [e["loss"] for e in r["continuous"]["epochs"]]})
    phase("train_cli_mesh", ranks=MESH_RANKS, backend="gloo", batch=cfg.train.batch_size,
          steps_by_epoch=steps, eval_windows_by_epoch=evals, wall_s=wall,
          rank0_epochs=epoch_report(cfg, {"epochs": ranks[0]["continuous"]["epochs"]}),
          per_rank=per_rank, resumed_vs_continuous_epoch_001=gaps or "bitwise equal")
    if gaps:
        raise AssertionError(f"train_cli_mesh: the resumed run's epoch_001 differs: {gaps}")
    return {"k3": sum(r[k]["launches"]["fused_dropout"] for r in ranks
                      for k in ("continuous", "resume")),
            "k1": sum(r[k]["launches"]["fused_ode_solve"] for r in ranks
                      for k in ("continuous", "resume"))}


def relative_transforms(results) -> list:
    """Each lane's frame-to-frame transforms from its accumulated
    trajectory (``kitti_eval``'s est_global)."""
    out = []
    for r in results:
        g = np.asarray(r["est_global"])
        out.append(np.linalg.inv(g[:-1]) @ g[1:])
    return out


def eval_lanes(model, root, cfg, dev, devices, seqs=EVAL_SEQS, k1_per_step=0, k2_per_step=0,
               name="eval_mesh", runs=range(MESH_RUN_TIMES)):
    """eval_runs over the ``runs`` of ``seqs`` (each its own seeded data
    dropout) at the flagship's eval dropout through
    make_infer_fn(fold_bn=True), its lanes over
    ``devices`` (None: one device), with the counts set to 0 just before
    and read just after (K1 and K2 per window step per replica as given):
    each lane's transforms, the launches, frames and wall seconds."""
    m = cfg.model
    infer = make_infer_fn(model, fold_bn=True, device=dev)
    evs = [KittiEvaluator(root, seqs, m.seq_len, (m.img_h, m.img_w),
                          cfg.data.eval_data_dropout, rng=np.random.default_rng(SEED + run))
           for run in runs]
    replicas = 1 if devices is None else len(devices)
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    t = time.perf_counter()
    runs = eval_runs(infer, evs, devices=devices)
    wall = time.perf_counter() - t
    k1, k2 = cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_cde_solve.launches
    steps = max(len(p) for ev in evs for p in ev.partitions)
    check_launches(f"{name} K1", k1, k1_per_step * steps * replicas)
    check_launches(f"{name} K2", k2, k2_per_step * steps * replicas)
    for run in runs:
        for seq, r in zip(seqs, run):
            if not all(math.isfinite(r[k]) for k in METRICS):
                raise AssertionError(f"{name}: sequence {seq} metrics {r}")
    frames = evs[0].timing["frames"]
    return {"poses": relative_transforms([r for ev in evs for r in ev.results]),
            "k1": k1, "k2": k2, "lanes": len(seqs) * len(evs), "frames": frames,
            "wall_s": wall, "frames_per_s": frames / wall,
            "decode_wait_share": evs[0].timing["decode_wait_s"] / evs[0].timing["wall_s"],
            "incomplete": infer.incomplete()}


def lane_gap(a: list, b: list) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def serve_mesh(dev, cfg, devices) -> tuple:
    """StreamingEngine(max_sessions=4) over ``devices`` on SCHEDULE's
    seeded windows against engines on one device: one per block of the
    split engine's lanes, serving that block's sessions (sessions take
    lanes in order, so session s sits in block s // lanes a block), which
    runs the encoders and the pose core at the split engine's batch sizes;
    and one of all four lanes, whose other batch sizes round otherwise.
    Returns the split engine's launches (K1 10 a step per replica), each
    session's gap to its block's engine and to the four-lane one, and the
    split and four-lane engines' step times in ms."""
    model = create_model(cfg, seed=SEED, device=dev)
    wins = make_windows(cfg, np.random.default_rng(SEED), len(SCHEDULE))
    per = SESSIONS // len(devices)
    runs = {"one": (SESSIONS, None, None), "split": (SESSIONS, devices, None),
            **{f"block{r}": (per, None, range(r * per, (r + 1) * per))
               for r in range(len(devices))}}
    out = {}
    for name, (lanes, devs, sessions) in runs.items():
        engine = StreamingEngine(model, max_sessions=lanes, fold_bn=True, device=dev,
                                 devices=devs)
        engine.warmup(wins[0][0])
        per_step = (cfg.model.seq_len - 1) * (1 if devs is None else len(devs))
        cuda_kernels.reset_launch_counts()      # this path's run starts here
        expected = None if sessions else [(per_step, 0)] * len(SCHEDULE)
        poses, lat, _ = serve(engine, wins, expected, sessions)
        out[name] = (poses, lat, cuda_kernels.fused_ode_solve.launches)

    def gap(ref) -> float:
        return max(float(np.abs(a[s] - b[s]).max()) for a, b in zip(ref, out["split"][0])
                   for s in a)

    block_gap = max(gap(out[f"block{r}"][0]) for r in range(len(devices)))
    return (out["split"][2], block_gap, gap(out["one"][0]),
            [x * 1e3 for x in out["split"][1]], [x * 1e3 for x in out["one"][1]])


def eval_mesh(dev, root) -> dict:
    """Eval lanes and serving sessions split over two replicas sharing the
    card, in bf16 and in float32: eval_runs of the three sequences twice
    (6 lanes, 3 a replica), each lane against the unsplit run within
    MESH_POSE_ATOL, and StreamingEngine with 4 sessions, each session
    against an engine of its block's lanes alone within MESH_POSE_ATOL
    (its gap to the four-lane engine is printed and not held: the serving
    encoders run the submitted lanes at their own batch sizes, and bf16
    rounds otherwise at other sizes); K1 10 a window step per replica. Then the cde model's eval of sequence 05 twice (a lane a
    replica, K2 once a window step per replica) against the two runs
    unsplit one at a time, which is what each replica computes, within
    MESH_POSE_ATOL; its gap to the unsplit run of both lanes in one call
    is printed and not held: the cde core's adaptive solve turns the
    other rounding of a batch of 2 into another step sequence
    (tests/test_torch_port_mesh.py::test_cde_solve_rows_are_independent
    shows its rows independent in float64)."""
    devices = [dev] * MESH_RANKS
    report, k1_eval, k1_serve = {}, 0, 0
    for dtype in ("bfloat16", "float32"):
        base = eval_config()
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, compute_dtype=dtype))
        model = create_model(cfg, seed=SEED, device=dev)
        k1 = cfg.model.seq_len - 1
        one = eval_lanes(model, root, cfg, dev, None, k1_per_step=k1,
                         name=f"eval_mesh_{dtype}_one")
        split = eval_lanes(model, root, cfg, dev, devices, k1_per_step=k1,
                           name=f"eval_mesh_{dtype}")
        k1_eval += split["k1"]
        gap = lane_gap(one.pop("poses"), split.pop("poses"))
        launches, serve_gap, four_gap, split_ms, one_ms = serve_mesh(dev, cfg, devices)
        k1_serve += launches
        report[dtype] = {"eval_split": split, "eval_one_device": one, "eval_lane_gap": gap,
                         "serve_launches": launches, "serve_session_gap": serve_gap,
                         "serve_session_gap_to_four_lanes": four_gap,
                         "serve_step_ms_split": split_ms, "serve_step_ms_one": one_ms}
        if gap > MESH_POSE_ATOL[dtype] or serve_gap > MESH_POSE_ATOL[dtype]:
            raise AssertionError(f"eval_mesh {dtype}: split against unsplit: eval {gap}, "
                                 f"serve {serve_gap} against its block's engine "
                                 f"(limit {MESH_POSE_ATOL[dtype]})")
        del model
        torch.cuda.empty_cache()
    cfg = cde_config()
    model = create_model(cfg, seed=SEED, device=dev)
    alone = [eval_lanes(model, root, cfg, dev, None, ("05",), k2_per_step=1,
                        name=f"eval_mesh_cde_run{run}", runs=(run,))
             for run in range(MESH_RUN_TIMES)]
    one = eval_lanes(model, root, cfg, dev, None, ("05",), k2_per_step=1,
                     name="eval_mesh_cde_one")
    split = eval_lanes(model, root, cfg, dev, devices, ("05",), k2_per_step=1,
                       name="eval_mesh_cde")
    gap = lane_gap([p for a in alone for p in a["poses"]], split["poses"])
    atol = MESH_POSE_ATOL[cfg.model.compute_dtype]
    report["cde"] = {"eval_split": {k: v for k, v in split.items() if k != "poses"},
                     "lane_gap_to_one_lane_a_call": gap, "pose_atol": atol,
                     "lane_gap_to_two_lanes_a_call": lane_gap(one["poses"], split["poses"])}
    if gap > atol:
        raise AssertionError(f"eval_mesh cde: split against the lanes run one at a time: "
                             f"{gap} (limit {atol})")
    phase("eval_mesh", replicas=MESH_RANKS, device=str(dev), run_times=MESH_RUN_TIMES,
          pose_atol=MESH_POSE_ATOL, **report)
    del model
    torch.cuda.empty_cache()
    return {"k1": {"eval_mesh": k1_eval, "serve_mesh": k1_serve}, "k2": split["k2"]}


def mesh(dev, work: Path, root) -> dict:
    """The mesh phase: train_mesh at the flagship's train configuration
    (B=16 global, 3 steps), train_cli_mesh, eval_mesh. Returns each
    kernel's launches by path."""
    cfg = train_config()
    train = train_mesh(dev, cfg, MESH_STEPS, k3_per_step=9)
    phase("train_mesh", **train["report"])
    cli = train_cli_mesh(dev, work, root)
    ev = eval_mesh(dev, root)
    return {"k1": {"train_cli_mesh_eval": cli["k1"], **ev["k1"]},
            "k2": {"eval_mesh_cde": ev["k2"]},
            "k3": {"train_mesh": train["k3"], "train_cli_mesh": cli["k3"]}}


# -- entry.py's entry points and the learning check ---------------------------
DRYRUN_DEVICES = 4           # JAX's dryrun_multichip(4): a (2, 2) mesh, 4 ranks on the card
ENTRY_RUNS = 10


def entry_phase(dev) -> dict:
    """entry(): the flagship forward at flagship width (seed-0 weights) on
    its batch-1 example, K1 10 launches (a window's frame intervals), the
    counts set to 0 just before and read just after; finite poses (1, 10,
    6) within EVAL_POSE_ATOL of the same weights through make_infer_fn
    with use_kernels=False (the slice phase's limit); both timed with
    CUDA events."""
    from ode_vio_tpu_torch.entry import entry

    t = time.perf_counter()
    fn, args = entry()
    build_s = time.perf_counter() - t
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    poses = fn(*args)
    torch.cuda.synchronize()
    k1 = cuda_kernels.fused_ode_solve.launches
    cfg = flagship_config()
    check_launches("entry K1", k1, cfg.model.seq_len - 1)
    check_launches("entry K2", cuda_kernels.fused_cde_solve.launches, 0)
    if tuple(poses.shape) != (1, cfg.model.seq_len - 1, 6) or not torch.isfinite(poses).all():
        raise AssertionError(f"entry: poses {tuple(poses.shape)}, finite "
                             f"{bool(torch.isfinite(poses).all())}")
    infer = make_infer_fn(meta_model(cfg, use_kernels=False), fn.model.state_dict(), device=dev)
    ref, _ = infer(*args)
    gap = float((poses - ref).abs().max())
    if gap > EVAL_POSE_ATOL:
        raise AssertionError(f"entry: poses {gap} from the solver core's (limit {EVAL_POSE_ATOL})")
    report = {"build_s": build_s, "k1_launches": k1, "poses_shape": list(poses.shape),
              "max_abs_pose_diff_to_solver_core": gap, "pose_atol": EVAL_POSE_ATOL,
              "ms": cuda_ms(lambda: fn(*args), runs=ENTRY_RUNS),
              "solver_core_ms": cuda_ms(lambda: infer(*args), runs=ENTRY_RUNS)}
    phase("entry", **report)
    del fn, infer
    torch.cuda.empty_cache()
    return {"k1": k1}


def dryrun_reference(cfg, dev) -> tuple:
    """``cfg``'s dryrun in this process, unsplit: its two steps' metrics,
    the trained tensors, the mean of the two steps' gradients (the
    accumulation cycle's update) and what it stores."""
    from ode_vio_tpu_torch.entry import dryrun_batch, stored_bytes

    model = create_model(cfg, seed=SEED, device=dev, train=True)
    state = create_train_state(cfg, model, seed=SEED + 1, device=dev)
    seen = record_grads(state)
    step = make_train_step(cfg, device=dev)
    batch = dryrun_batch(cfg, dev)
    metrics = []
    for _ in range(2):
        state, m = step(state, *batch)
        metrics.append({k: float(v) for k, v in m.items()})
    mean = {k: (seen[0][k] + seen[1][k]) / 2 for k in seen[0]}
    return metrics, trained_tensors(state), mean, stored_bytes(state)


def dryrun_rank(dev, cfg, shape) -> dict:
    """One rank of the dryrun's parity run: entry.dryrun_steps with TF32
    off, as env() sets it for the one process it is held against (a
    spawned rank starts with PyTorch's defaults: cuDNN in TF32)."""
    from ode_vio_tpu_torch.entry import dryrun_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dryrun_steps(dev, cfg, shape)


def dryrun_phase(dev) -> dict:
    """dryrun_multichip(4): JAX's tiny configuration (image encoder
    trained, trunk dropout through K3) on a (2, 2) mesh of four ranks
    sharing the card over gloo, each storing half of every weight the
    rules split, for one cycle of two-step accumulation: JAX's ok line,
    the ranks' metrics equal, K3 18 a step on every rank (the trunk's 9
    forward and 9 backward), each rank's parameters the unsplit model's
    less half of the split ones. Then the same configuration without
    dropout (the frozen encoder's folded graph, so that the ranks draw
    nothing) on the four ranks against one process unsplit on the global
    batch: both steps' loss and grad_norm within MESH_STEP_RTOL, the
    gathered trained tensors too where the gradient clears rounding
    (clear_gaps), and the stored bytes of parameters and optimizer state
    the unsplit process's less half of the split ones."""
    from ode_vio_tpu_torch.entry import dryrun_config, dryrun_multichip
    from ode_vio_tpu_torch.parallel.mesh import launch

    cfg, shape = dryrun_config(DRYRUN_DEVICES)
    t = time.perf_counter()
    ranks = dryrun_multichip(DRYRUN_DEVICES, "cuda")
    wall = time.perf_counter() - t
    with torch.device("meta"):
        whole_bytes = sum(p.numel() * p.element_size()
                          for p in DeepVIO(cfg.model, cfg.solver, cfg.cde_solver_cfg).parameters())
    k3 = 0
    for r in ranks:
        want = {"fused_dropout": 18 * 2, "fused_ode_solve": 0, "fused_cde_solve": 0}
        if r["launches"] != want:
            raise AssertionError(f"dryrun_multichip rank {r['rank']}: launches {r['launches']}, "
                                 f"expected {want}")
        k3 += r["launches"]["fused_dropout"]
        b = r["stored_bytes"]
        if r["metrics"] != ranks[0]["metrics"] or not b["params_split"] or \
                b["params"] + b["params_split"] != whole_bytes:
            raise AssertionError(f"dryrun_multichip rank {r['rank']}: metrics {r['metrics']}, "
                                 f"stored {b}, unsplit parameters {whole_bytes} bytes")
    quiet = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, freeze_encoder=True, frozen_encoder_eval=True))
    split = launch(dryrun_rank, [dev] * DRYRUN_DEVICES, quiet, shape, backend="gloo")
    metrics, want, grads, one_bytes = dryrun_reference(quiet, dev)
    gaps = clear_gaps(split[0]["state"], want, grads, MESH_STEP_RTOL)
    rel = {f"{k}_step{i}": abs(got[k] - ref[k]) / abs(ref[k])
           for i, (got, ref) in enumerate(zip(split[0]["metrics"], metrics))
           for k in ("loss", "grad_norm")}
    bytes_ok = all(r["stored_bytes"][k] + r["stored_bytes"][f"{k}_split"] == one_bytes[k]
                   and r["stored_bytes"][f"{k}_split"] > 0
                   for r in split for k in ("params", "optimizer"))
    report = {"mesh": dict(zip(("data", "model"), shape)), "ranks": DRYRUN_DEVICES,
              "backend": "gloo", "wall_s": wall, "losses": [m["loss"] for m in ranks[0]["metrics"]],
              "stored_bytes": [r["stored_bytes"] for r in ranks], "k3_launches": k3,
              "parity": {"rel": rel, "worst_tensor_gap_over_limit": max(gaps.values()),
                         "tensors": len(gaps), "rtol": MESH_STEP_RTOL,
                         "stored_bytes_split": split[0]["stored_bytes"],
                         "stored_bytes_one_process": one_bytes}}
    phase("dryrun_multichip", **report)
    if max(rel.values()) > MESH_STEP_RTOL or max(gaps.values()) > 1.0 or not bytes_ok:
        bad = {k: v for k, v in gaps.items() if v > 1.0}
        raise AssertionError(f"dryrun_multichip: split against one process: {rel}, tensors "
                             f"over the limit {bad}, stored bytes as expected {bytes_ok}")
    torch.cuda.empty_cache()
    return {"k3": k3}


def learn_phase(dev, work: Path) -> dict:
    """The odometric convergence recipe (experiments/convergence.py, JAX's
    tests/test_convergence.py) on the card: the eval RMSE after training
    below 0.5x the untrained model's; K3 18 a train step (the trunk trains),
    K1 a frame interval of each eval window, before and after, the counts
    set to 0 just before and read just after."""
    from ode_vio_tpu_torch.experiments.convergence import (IMG_HW, SEQ_LEN, learn,
                                                          make_tree)

    root = make_tree("odometric", work / "learn")
    cuda_kernels.reset_launch_counts()          # this path's run starts here
    t = time.perf_counter()
    out = learn("odometric", root, device=dev)
    wall = time.perf_counter() - t
    k1, k3 = cuda_kernels.fused_ode_solve.launches, cuda_kernels.fused_dropout.launches
    windows = len(EvalPartition(root, "05", SEQ_LEN, IMG_HW, 0.0, None))
    check_launches("learn K3", k3, 18 * len(out["losses"]))
    check_launches("learn K1", k1, 2 * windows * (SEQ_LEN - 1))
    check_launches("learn K2", cuda_kernels.fused_cde_solve.launches, 0)
    phase("learn", wall_s=wall, train_seconds=out["train_seconds"], epochs=out["epochs"],
          steps=len(out["losses"]), first_loss=out["losses"][0], last_loss=out["losses"][-1],
          eval_rmse_before=out["before"], eval_rmse_after=out["after"],
          ratio=out["after"] / out["before"], limit=0.5, k1=k1, k3=k3)
    if not out["after"] < 0.5 * out["before"]:
        raise AssertionError(f"learn: eval RMSE {out['before']} -> {out['after']}, not below "
                             "half")
    return {"k1": k1, "k3": k3}


def main() -> None:
    seconds = {}

    def timed(what, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[what] = round(time.perf_counter() - t, 3)
        return out

    name = timed("env", env)
    dev = torch.device("cuda", 0)
    timed("build", build)
    k1 = timed("kernel", kernel_check, dev)
    k2 = timed("kernel_cde", kernel_cde_check, dev)
    k1_launches = timed("slice_core", slice_phases, dev)
    k2_by_path = timed("cde_rde", cde_phases, dev)
    # the eval and serve phases work in a directory of the checkout that
    # is removed afterwards (the synthetic tree is 0.42 GB)
    work = Path(__file__).resolve().parent / "ode_vio_tpu_torch" / "_build" / (
        f"eval_smoke-{os.getpid()}")
    try:
        root = timed("eval_data", eval_data, work)
        ev = timed("eval_stream", eval_stream, dev, root)
        cli = timed("eval_cli", eval_cli, dev, work, root, ev.pop("model"))
        torch.cuda.empty_cache()
        serve_launches = timed("serve_cli", serve_cli, dev, work, root, cli["pth"])
        torch.cuda.empty_cache()
        tcli = timed("train_cli", train_cli, dev, work, root)
        tcde = timed("train_cli_cde", train_cli_cde, dev, work, root)
        tbptt = timed("train_tbptt", train_tbptt, dev, work, root)
        carry = timed("train_carry", train_carry, dev, work, root)
        k3_cores = timed("cores", cores, dev, work, root)
        modes = timed("solver_modes", solver_modes, dev, work, root)
        enc = timed("encoders", encoders_phase, dev, work, root, cli["pth"])
        edg = timed("edges", edges, dev, work, root)
        msh = timed("mesh", mesh, dev, work, root)
        ent = timed("entry", entry_phase, dev)
        dry = timed("dryrun_multichip", dryrun_phase, dev)
        lrn = timed("learn", learn_phase, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k1_by_path = {"slice": k1_launches, **ev["launches"], "eval_cli": cli["k1"],
                  **serve_launches, **tcli["k1"], **carry["k1"], **modes["k1"], **enc["k1"],
                  **edg["k1"], **msh["k1"], "entry": ent["k1"], "learn_eval": lrn["k1"]}
    k2_by_path["eval_cli_cde"] = cli["k2"]
    k2_by_path["train_cli_cde_eval"] = tcde["k2"]
    k2_by_path["train_tbptt_eval"] = tbptt["k2"]
    k2_by_path.update(carry["k2"], **modes["k2"], **msh["k2"])
    k3 = timed("kernel_dropout", kernel_dropout_check, dev)
    k3_by_path = timed("train", train_phases, dev)
    k3_by_path.update(tcli["k3"], train_cli_cde=tcde["k3"], train_rde=tcde["k3_rde"],
                      train_tbptt=tbptt["k3"], **carry["k3"], **k3_cores, **modes["k3"],
                      **enc["k3"], **edg["k3"], **msh["k3"], dryrun_multichip=dry["k3"],
                      learn=lrn["k3"])
    phase("seconds", **seconds)
    print(json.dumps({"kernels": [
        {"name": "fused_ode_solve", "route": "cuda",
         "source": "ode_vio_tpu_torch/csrc/fused_ode_solve.cu",
         "replaces": "ode_vio_tpu/ops/pallas_kernels.py:42",
         "launches": sum(k1_by_path.values()), "launches_by_path": k1_by_path,
         "library_ms": None, **k1},
        {"name": "fused_cde_solve", "route": "cuda",
         "source": "ode_vio_tpu_torch/csrc/fused_cde_solve.cu",
         "replaces": "ode_vio_tpu/ops/pallas_kernels.py:213",
         "launches": sum(k2_by_path.values()), "launches_by_path": k2_by_path,
         "library_ms": None, **k2},
        {"name": "fused_dropout", "route": "cuda",
         "source": "ode_vio_tpu_torch/csrc/fused_dropout.cu",
         "replaces": "ode_vio_tpu/ops/pallas_kernels.py:534",
         "launches": sum(k3_by_path.values()), "launches_by_path": k3_by_path, **k3}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
