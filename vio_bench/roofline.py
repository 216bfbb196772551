"""Peaks of one NVIDIA H100 and the least time a piece of work needs.

Published SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): bf16
989 TFLOP/s on the tensor cores, float32 67 TFLOP/s outside them, HBM3 at
3.35 TB/s. A run records the card's power limit beside every share of
these peaks.

The bound of a solver kernel is copied from the repository's smoke run:
the field evaluations its inputs need, 2 flops a weight each, at the
float32 peak, or the bytes it must move at the HBM rate, whichever is
longer. The evaluations are counted by the benchmark's plain reference for
the same inputs, never by the kernel itself, so a change to the solver
cannot move the yardstick.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_time_s(bf16_flops: float, f32_flops: float) -> float:
    """The least time for work done part in bf16 and part in float32."""
    return bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS


def solver_bound_s(evals: int, field_weights: int, nbytes: int) -> float:
    """The least time of an adaptive solve that needs ``evals`` field
    evaluations of a field with ``field_weights`` multiply-adds per row,
    moving at least ``nbytes``."""
    return max(evals * 2 * field_weights / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def share_pct(least_s: float, took_s: float):
    """``least_s`` as a percentage of ``took_s``; None where nothing was
    timed (a reader then reports nothing)."""
    if not took_s or took_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / took_s
