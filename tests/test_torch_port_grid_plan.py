"""The grid plan of kernels K1 and K2 (``ops/cuda_kernels.py::ode_grid_plan``,
``cde_grid_plan``): how a field's layers are split over one block per SM,
whether the weights fit in the blocks' shared memory, and the int array the
kernels read; how many rows one launch takes, and the wrappers' split of
more rows into several launches. Plain Python, on the CPU."""

import numpy as np
import pytest
import torch

from ode_vio_tpu_torch.ops import cuda_kernels
from ode_vio_tpu_torch.ops.cuda_kernels import (PLAN_WORDS, cde_grid_plan, in_row_pieces,
                                                max_grid_rows, ode_grid_plan)

H100_BLOCKS = 132
SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory, opt-in limit (227 KB)
ODE_FLAGSHIP = (768, 1024, 1024, 768)


def cde_dims(channels, hidden=128, layers=3):
    return (hidden,) + (hidden,) * layers + (hidden * channels,)


def check_ranges(plan, dims):
    """Every output row of every layer owned by exactly one block, in
    contiguous ranges whose sizes differ by at most one unit."""
    for l, (starts, unit) in enumerate(zip(plan.starts, plan.unit_rows)):
        assert len(starts) == plan.n_blocks + 1
        assert starts[0] == 0 and starts[-1] * unit == dims[l + 1]
        sizes = [b - a for a, b in zip(starts, starts[1:])]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        owners = [b for b, n in enumerate(sizes) for _ in range(n * unit)]
        assert len(owners) == dims[l + 1]                       # each row once
        assert owners == sorted(owners)                         # contiguous


def check_regions(plan, limit=SMEM_PER_BLOCK):
    """The shared-memory regions lie inside the plan's bytes and do not
    overlap; the whole fits in one block."""
    assert plan.smem_bytes <= limit
    starts = sorted(plan.smem.values())
    assert starts[0] == 0 and all(s % 4 == 0 for s in starts)
    assert 4 * starts[-1] < plan.smem_bytes


@pytest.mark.parametrize("n_rows", [1, 5, 12, 96])
@pytest.mark.parametrize("n_blocks", [1, 7, 132])
def test_ode_plan_owns_every_row_once(n_rows, n_blocks):
    # below 132 blocks the field does not fit an H100's blocks; the
    # ownership holds for any limit
    limit = SMEM_PER_BLOCK * 132 // n_blocks
    plan = ode_grid_plan(ODE_FLAGSHIP, n_rows, n_blocks, smem_limit=limit)
    check_ranges(plan, ODE_FLAGSHIP)
    check_regions(plan, limit)
    assert plan.unit_rows == (1, 1, 1)
    assert plan.own_max == -(-768 // n_blocks)


@pytest.mark.parametrize("channels", [129, 45, 3])
@pytest.mark.parametrize("n_blocks", [1, 100, 132, 300])
def test_cde_plan_keeps_each_h_in_one_block(channels, n_blocks):
    dims = cde_dims(channels, hidden=128 if channels > 3 else 16)
    plan = cde_grid_plan(dims, channels, 4, n_blocks, smem_limit=10 ** 9)
    check_ranges(plan, dims)
    assert plan.unit_rows[-1] == channels
    H = dims[0]
    for a, b in zip(plan.starts[-1], plan.starts[-1][1:]):
        # block owns h in [a, b): the rows [a*C, b*C), whole h only
        assert 0 <= a <= b <= H
    assert plan.own_max == -(-H // n_blocks)


@pytest.mark.parametrize("n_rows", [12, 96])
def test_flagship_fields_are_resident_on_an_h100(n_rows):
    plans = {"ode": ode_grid_plan(ODE_FLAGSHIP, n_rows, H100_BLOCKS, SMEM_PER_BLOCK),
             "cde": cde_grid_plan(cde_dims(129), 129, n_rows, H100_BLOCKS, SMEM_PER_BLOCK),
             "rde": cde_grid_plan(cde_dims(45), 45, n_rows, H100_BLOCKS, SMEM_PER_BLOCK)}
    for name, plan in plans.items():
        assert plan.resident, name
        assert plan.smem_bytes <= SMEM_PER_BLOCK, name
        check_regions(plan)
    # K1: ~8 rows of each hidden layer and 6 of the last per block, ~80 KB
    assert plans["ode"].resident_bytes == 4 * (8 * 768 + 8 * 1024 + 6 * 1024)
    # K2: one h of the last layer (129 x 128 floats, 66 KB) and at most one
    # row of each hidden layer
    assert plans["cde"].resident_bytes == 4 * (3 * 128 + 129 * 128)
    assert plans["ode"].row_chunk == (n_rows if n_rows == 12 else 29)


def test_ode_row_chunks_fill_what_the_weights_leave():
    plan = ode_grid_plan(ODE_FLAGSHIP, 96, H100_BLOCKS, SMEM_PER_BLOCK)
    larger = ode_grid_plan(ODE_FLAGSHIP, 96, H100_BLOCKS, smem_limit=SMEM_PER_BLOCK + 4096)
    assert plan.row_chunk < 96 and larger.row_chunk == plan.row_chunk + 1


def test_too_wide_a_field_is_streamed():
    # 2x the flagship's widths: 42 MB of f32 weights, more than 132 x 227 KB
    wide = (1536, 2048, 2048, 1536)
    assert 4 * sum(a * b for a, b in zip(wide, wide[1:])) > H100_BLOCKS * SMEM_PER_BLOCK
    plan = ode_grid_plan(wide, 12, H100_BLOCKS, SMEM_PER_BLOCK)
    assert not plan.resident and plan.resident_bytes == 0
    assert not any(k.startswith("off_w") for k in plan.smem)
    check_ranges(plan, wide)
    check_regions(plan)
    assert plan.row_chunk == 12
    # the cde field at a very wide hidden layer
    dims = cde_dims(129, hidden=1024)
    assert not cde_grid_plan(dims, 129, 4, H100_BLOCKS, SMEM_PER_BLOCK).resident


def test_plan_words_are_the_header_then_the_starts():
    plan = cde_grid_plan(cde_dims(129), 129, 4, H100_BLOCKS, SMEM_PER_BLOCK)
    words = plan.words()
    head = dict(zip(PLAN_WORDS, words))
    assert len(PLAN_WORDS) == 30  # csrc/adaptive_rk.cuh::kPlanHeader
    assert (head["n_blocks"], head["n_rows"], head["resident"]) == (H100_BLOCKS, 4, 1)
    assert head["smem_bytes"] == plan.smem_bytes and head["own_max"] == 1
    assert head["off_w3"] == plan.smem["off_w3"] and head["off_w4"] == 0
    assert head["scr_floats"] == plan.scratch_floats
    starts = words[len(PLAN_WORDS):]
    assert len(starts) == 4 * (H100_BLOCKS + 1)
    assert starts[-(H100_BLOCKS + 1):] == list(plan.starts[-1])
    # scratch: stage inputs (2 x rows x H), partial sums, 3 hidden outputs
    assert plan.scratch_floats == 2 * 4 * 128 + H100_BLOCKS * 4 + 3 * 4 * 128


@pytest.mark.parametrize("bad", [dict(n_blocks=0), dict(n_rows=0), dict(n_rows=-1),
                                 dict(smem_limit=4096)])
def test_impossible_plans_raise(bad):
    kw = {**dict(dims=ODE_FLAGSHIP, n_rows=12, n_blocks=H100_BLOCKS,
                 smem_limit=SMEM_PER_BLOCK), **bad}
    with pytest.raises(ValueError):
        ode_grid_plan(**kw)


def test_impossible_cde_plans_raise():
    with pytest.raises(ValueError, match="H\\*C"):
        cde_grid_plan(cde_dims(129), 128, 4, H100_BLOCKS, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="channels"):
        cde_grid_plan(cde_dims(129), 0, 4, H100_BLOCKS, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="blocks"):
        cde_grid_plan(cde_dims(129), 129, 4, 0, SMEM_PER_BLOCK)


@pytest.mark.parametrize("dims,channels,served", [
    (ODE_FLAGSHIP, 0, 96), (cde_dims(129), 129, 32), (cde_dims(45), 45, 32),
    ((1536, 2048, 2048, 1536), 0, 12)])
def test_max_grid_rows_is_where_the_plan_stops(dims, channels, served):
    """Each row's controller state and state components live in every
    block, so one launch takes a bounded number of rows; the limit is
    exactly the last row count the plan accepts, far above what serving 32
    sessions sends."""
    rows = max_grid_rows(dims, H100_BLOCKS, SMEM_PER_BLOCK, 7, channels)
    assert rows >= 4 * served
    plan = cuda_kernels._grid_plan(dims, rows, H100_BLOCKS, 7, channels, SMEM_PER_BLOCK)
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.row_chunk >= 1
    with pytest.raises(ValueError, match="split"):
        cuda_kernels._grid_plan(dims, rows + 1, H100_BLOCKS, 7, channels, SMEM_PER_BLOCK)
    assert max_grid_rows(dims, H100_BLOCKS, 1024, 7, channels) == 0


def test_rows_past_one_launch_run_in_pieces():
    """in_row_pieces, as the wrappers use it for more rows than one launch
    takes: the plain K1 on 5 rows in pieces of 2 (three calls) gives what
    one call gives; rows do not interact, so the counts are equal and y
    agrees to the last bits of the batched products."""
    rng = np.random.default_rng(0)
    sizes = [8, 16, 8]
    layers = [(torch.from_numpy((rng.standard_normal((b, a)) / np.sqrt(a)).astype(np.float32)),
               torch.from_numpy((0.01 * rng.standard_normal(b)).astype(np.float32)))
              for a, b in zip(sizes, sizes[1:])]
    y0 = torch.from_numpy(np.tanh(rng.standard_normal((5, 8))).astype(np.float32))
    t0 = torch.from_numpy(rng.uniform(0, 0.5, 5).astype(np.float32))
    t1 = t0 + torch.from_numpy(rng.uniform(0.08, 0.13, 5).astype(np.float32))
    dt0 = torch.full((5,), 1e-3)
    kw = dict(activation="softplus", method="dopri5", rtol=1e-4, atol=1e-6, max_steps=64,
              safety=0.9, factor_min=0.2, factor_max=10.0)
    calls = []

    def plain(y0, t0, t1, dt0):
        calls.append(y0.shape[0])
        return cuda_kernels.fused_ode_solve_plain(layers, y0, t0, t1, dt0, **kw)

    whole = plain(y0, t0, t1, dt0)
    pieces = in_row_pieces(plain, 5, 2, (y0, t0, t1, dt0))
    assert calls == [5, 2, 2, 1]
    in_row_pieces(plain, 5, 4, (y0, t0, t1, dt0))  # two pieces, as even as they go
    assert calls[-2:] == [3, 2]
    for k in (2, 3, 4):
        assert torch.equal(pieces[k], whole[k])
    torch.testing.assert_close(pieces[0], whole[0], rtol=1e-6, atol=1e-7)
    assert in_row_pieces(plain, 5, 5, (y0, t0, t1, dt0))[0] is not None and calls[-1] == 5
    # None arguments (a linear path's c and d) pass through to every piece
    seen = []
    in_row_pieces(lambda a, b: seen.append(b) or (a,), 3, 1, (y0[:3], None))
    assert seen == [None, None, None]
    with pytest.raises(ValueError):
        in_row_pieces(plain, 5, 0, (y0, t0, t1, dt0))
