"""Floating-point operations of the DeepVIO models, from shapes.

A multiply-add is 2 operations. Only the matrix products and convolutions
are counted; BatchNorm, activations and the solver's vector updates are
left out (each is under 1 % of its layer). Each count says the precision
its layer runs in: the encoders in the configuration's ``compute_dtype``
(bf16), the pose core in float32.
"""

from __future__ import annotations

from vio_bench.reference.model import IMU_CHANNELS, IMU_FREQ, TRUNK, trunk_out_hw


def trunk_per_pair(img_h: int, img_w: int) -> int:
    """The nine convolutions over one frame pair."""
    total, c_in, h, w = 0, 6, img_h, img_w
    for _, c_out, k, s in TRUNK:
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        total += 2 * c_out * c_in * k * k * h * w
        c_in = c_out
    return total


def encoders_per_interval(m: dict) -> int:
    """The visual encoder over one frame pair and the inertial encoder over
    its 11 IMU samples, with their projections."""
    h, w = trunk_out_hw(m["img_h"], m["img_w"])
    visual = trunk_per_pair(m["img_h"], m["img_w"]) + 2 * m["v_f_len"] * TRUNK[-1][1] * h * w
    inertial, c_in = 0, 6
    for c_out in IMU_CHANNELS:
        inertial += 2 * c_out * c_in * 3 * (IMU_FREQ + 1)
        c_in = c_out
    inertial += 2 * m["i_f_len"] * c_in * (IMU_FREQ + 1)
    return visual + inertial


def field_weights(m: dict) -> int:
    """Multiply-adds of one evaluation of the solved field for one row:
    the ODE MLP (ode-rnn), or the CDE MLP and its product with the path's
    slope (cde); 0 for a core that solves nothing."""
    f = m["v_f_len"] + m["i_f_len"]
    if m["model_type"] == "ode-rnn":
        sizes = [f] + [m["ode_hidden_dim"]] * m["ode_fn_num_layers"] + [f]
        return sum(a * b for a, b in zip(sizes, sizes[1:]))
    if m["model_type"] == "cde":
        H = m["cde_hidden_dim"]
        sizes = [H] + [H] * m["cde_fn_num_layers"] + [H * (H + 1)]
        return sum(a * b for a, b in zip(sizes, sizes[1:])) + H * (H + 1)
    return 0


def pose_core_per_interval(m: dict) -> int:
    """The pose core's work per lane and frame interval outside the solve:
    fusion, the RNN stack or the CDE's reduction, and the regressor."""
    f = m["v_f_len"] + m["i_f_len"]
    total = 2 * f * f if m["fuse_method"] == "soft" else 0
    if m["model_type"] in ("ode-rnn", "rnn"):
        total += m["rnn_num_layers"] * 2 * 2 * f * f + 2 * (f * 128 + 128 * 6)
    elif m["model_type"] == "cde":
        H = m["cde_hidden_dim"]
        total += 2 * (f * (f // 2) + (f // 2) * H) + 2 * (H * 128 + 128 * 6)
    return total


def window_flops(m: dict, windows: int, evals: int):
    """(bf16, float32) operations of ``windows`` served windows whose solves
    needed ``evals`` field evaluations in all."""
    intervals = windows * (m["seq_len"] - 1)
    enc = intervals * encoders_per_interval(m)
    core = intervals * pose_core_per_interval(m) + 2 * evals * field_weights(m)
    if m["compute_dtype"] == "float32":
        return 0, enc + core
    return enc, core
