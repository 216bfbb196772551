"""Inference-time BatchNorm folding on a reference-layout state_dict
(counterpart of ``ode_vio_tpu/models/fold.py``).

With frozen running statistics a BatchNorm is a per-channel affine, so it
folds into the preceding convolution::

    s  = gamma / sqrt(var + eps)
    W' = W * s                 (over the output-channel axis 0)
    b' = (b - mean) * s + beta (b = 0 where the conv has no bias)

:func:`fold_batchnorm_into_bias` moves ``b'`` into the conv's bias and
drops the BatchNorm entries: the result loads into a model built with
``skip_bn=True``. :func:`fold_batchnorm` keeps every entry and turns each
BatchNorm into an exact identity plus shift (weight 1, bias ``b'``, mean 0,
var ``1 - eps``), for the encoders whose convs are not the plain one
(``encoder_int8``, ``encoder_s2d``). Exact at eval; never for training.
"""

from __future__ import annotations

from typing import Dict

import torch

from ode_vio_tpu_torch.models.encoders import BN_EPS

_BN_ENTRIES = ("weight", "bias", "running_mean", "running_var",
               "num_batches_tracked")


def _pairs(state_dict: Dict[str, torch.Tensor]):
    """``(bn, conv, s, mean, beta)`` of every BatchNorm at index
    ``<base>.<i>`` and its conv at ``<base>.<i-1>`` (the reference's
    ``conv1.0``/``conv1.1`` and ``encoder_conv.0``/``encoder_conv.1``
    pairs), with the BatchNorm's scale ``s``, in float32."""
    for key in state_dict:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        base, idx = bn.rsplit(".", 1)
        gamma, beta, mean, var = (state_dict[f"{bn}.{n}"].float() for n in _BN_ENTRIES[:4])
        # the float32 square root correctly rounded (through float64), as
        # numpy, XLA and CUDA give it; torch's vectorized CPU sqrt is off by
        # one ulp for ~0.5 % of float32 inputs
        root = torch.sqrt((var + BN_EPS).double()).float()
        yield bn, f"{base}.{int(idx) - 1}", gamma / root, mean, beta


def _scaled(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (w.float() * s.reshape((-1,) + (1,) * (w.dim() - 1))).to(w.dtype)


def fold_batchnorm_into_bias(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every (conv, BatchNorm) pair as one conv with kernel ``W * s`` and
    bias ``(b - mean) * s + beta``; the BatchNorm entries are dropped."""
    out = dict(state_dict)
    for bn, conv, s, mean, beta in _pairs(state_dict):
        w = state_dict[f"{conv}.weight"]
        out[f"{conv}.weight"] = _scaled(w, s)
        bias = state_dict.get(f"{conv}.bias")
        b0 = torch.zeros_like(mean) if bias is None else bias.float()
        out[f"{conv}.bias"] = ((b0 - mean) * s + beta).to(
            w.dtype if bias is None else bias.dtype)
        for n in _BN_ENTRIES:
            out.pop(f"{bn}.{n}", None)
    return out


def fold_batchnorm(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every (conv, BatchNorm) pair folded by value (JAX ``fold_batchnorm``):
    kernel ``W * s``; the BatchNorm weight 1, bias the whole shift (``beta
    - mean * s``, or ``(b - mean) * s + beta`` where the conv has a bias,
    which becomes 0), running mean 0 and running var ``1 - eps``, so that
    it adds the shift and nothing else. The keys do not change."""
    out = dict(state_dict)
    for bn, conv, s, mean, beta in _pairs(state_dict):
        w = state_dict[f"{conv}.weight"]
        out[f"{conv}.weight"] = _scaled(w, s)
        bias = state_dict.get(f"{conv}.bias")
        if bias is None:
            shift = beta - mean * s
        else:
            shift = (bias.float() - mean) * s + beta
            out[f"{conv}.bias"] = torch.zeros_like(bias)
        out[f"{bn}.weight"] = torch.ones_like(state_dict[f"{bn}.weight"])
        out[f"{bn}.bias"] = shift.to(state_dict[f"{bn}.bias"].dtype)
        out[f"{bn}.running_mean"] = torch.zeros_like(state_dict[f"{bn}.running_mean"])
        out[f"{bn}.running_var"] = torch.full_like(state_dict[f"{bn}.running_var"],
                                                   1.0 - BN_EPS)
    return out
