"""Inference-time BatchNorm folding on a reference-layout state_dict
(counterpart of ``ode_vio_tpu/models/fold.py::fold_batchnorm_into_bias``).

With frozen running statistics a BatchNorm is a per-channel affine, so it
folds into the preceding convolution::

    s  = gamma / sqrt(var + eps)
    W' = W * s                 (over the output-channel axis 0)
    b' = (b - mean) * s + beta (b = 0 where the conv has no bias)

and the BatchNorm entries leave the state_dict. The result loads into a
model built with ``skip_bn=True``. Exact at eval; never for training.
"""

from __future__ import annotations

from typing import Dict

import torch

from ode_vio_tpu_torch.models.encoders import BN_EPS

_BN_ENTRIES = ("weight", "bias", "running_mean", "running_var",
               "num_batches_tracked")


def fold_batchnorm_into_bias(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every BatchNorm at index ``<base>.<i>`` folds into the conv at
    ``<base>.<i-1>`` (the reference's ``conv1.0``/``conv1.1`` and
    ``encoder_conv.0``/``encoder_conv.1`` pairs)."""
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        base, idx = bn.rsplit(".", 1)
        conv = f"{base}.{int(idx) - 1}"
        gamma, beta, mean, var = (state_dict[f"{bn}.{n}"].float() for n in _BN_ENTRIES[:4])
        s = gamma / torch.sqrt(var + BN_EPS)
        w = state_dict[f"{conv}.weight"]
        out[f"{conv}.weight"] = (w.float() * s.reshape((-1,) + (1,) * (w.dim() - 1))).to(w.dtype)
        bias = state_dict.get(f"{conv}.bias")
        b0 = torch.zeros_like(mean) if bias is None else bias.float()
        out[f"{conv}.bias"] = ((b0 - mean) * s + beta).to(
            w.dtype if bias is None else bias.dtype)
        for n in _BN_ENTRIES:
            out.pop(f"{bn}.{n}", None)
    return out
