"""Visual and inertial feature encoders (counterpart of
``ode_vio_tpu/models/encoders.py``).

The public layout is the JAX package's: ``img (B, S, H, W, 3)`` and
``imu (B, 10*(S-1)+1, 6)``. Inside, convolutions run NCHW / NCL, so the
trunk output flattens in the reference's CHW order (and the IMU features
in its C-major (256, 11) order): the order that ``visual_head`` and
``proj`` hold their weight columns in, in the reference state_dict layout.
That is the JAX model's HWC / L-major flatten under the column
permutation of ``ode_vio_tpu/models/convert.py``.

Convolutions and the two heads run in ``compute_dtype``; BatchNorm
statistics stay float32, applied as flax applies them
(``(x - mean) * (gamma * rsqrt(var + eps)) + beta`` in float32, then cast);
the outputs are float32. With ``skip_bn`` (the folded inference graph,
models/fold.py) each conv carries the folded shift as its bias and the
BatchNorm slots hold ``nn.Identity``, so state_dict indices do not move.

In train mode (``module.train()``) BatchNorm takes the batch statistics
as flax computes them (``use_fast_variance``: ``mean(x^2) - mean(x)^2``
in float32, clipped at 0) and moves its running statistics 0.1 of the
way to them, the variance biased; dropout draws from the ``generator``
the forward is given: the conv trunk through kernel K3 when
``fast_dropout`` (``models/common.py::train_dropout``), the IMU encoder a
Bernoulli mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_vio_tpu_torch.config import ModelConfig
from ode_vio_tpu_torch.models.common import train_dropout

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch

# reference conv-trunk names and (features, kernel, stride, dropout)
TRUNK_NAMES = ("conv1", "conv2", "conv3", "conv3_1", "conv4",
               "conv4_1", "conv5", "conv5_1", "conv6")
TRUNK: Sequence[Tuple[int, int, int, float]] = (
    (64, 7, 2, 0.2), (128, 5, 2, 0.2), (256, 5, 2, 0.2), (256, 3, 1, 0.2),
    (512, 3, 2, 0.2), (512, 3, 1, 0.2), (512, 3, 2, 0.2), (512, 3, 1, 0.2),
    (1024, 3, 2, 0.5),
)
IMU_FREQ = 10          # IMU rows per image interval
IMU_CHANNELS = (64, 128, 256)


def trunk_out_hw(img_h: int, img_w: int) -> Tuple[int, int]:
    """Conv-trunk output spatial shape: (256, 512) -> (4, 8)."""
    h, w = img_h, img_w
    for _, k, s, _ in TRUNK:
        h = (h - 1) // s + 1
        w = (w - 1) // s + 1
    return h, w


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _batchnorm_f32(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d):
    """BatchNorm over (N, C, ...) in float32, as flax's ``_normalize``
    computes it: with the batch statistics in train mode (updating the
    running ones), else with the running statistics."""
    if bn.training:
        dims = [0, *range(2, x.dim())]
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    return (x.float() - mean.reshape(shape)) * mul.reshape(shape) + bn.bias.reshape(shape)


def _bias(layer: nn.Module, dtype: torch.dtype):
    return None if layer.bias is None else layer.bias.to(dtype)


class ConvBlock(nn.Sequential):
    """Conv2d (symmetric padding) + BatchNorm + LeakyReLU(0.1) + Dropout,
    at the reference indices 0..3."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 dropout: float, skip_bn: bool = False):
        super().__init__(
            nn.Conv2d(c_in, c_out, kernel, stride=stride,
                      padding=(kernel - 1) // 2, bias=skip_bn),
            nn.Identity() if skip_bn else nn.BatchNorm2d(c_out, eps=BN_EPS),
            nn.LeakyReLU(0.1),
            nn.Dropout(dropout),
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                fast_dropout: bool = True, use_kernels: bool = False) -> torch.Tensor:
        conv, bn = self[0], self[1]
        dtype = x.dtype
        x = F.conv2d(x, conv.weight.to(dtype), _bias(conv, dtype),
                     conv.stride, conv.padding)
        if isinstance(bn, nn.BatchNorm2d):
            x = _batchnorm_f32(x, bn).to(dtype)
        x = F.leaky_relu(x, 0.1)
        if not self.training:
            return x
        return train_dropout(x, self[3].p, generator, fast=fast_dropout,
                             use_kernels=use_kernels)


class ImageEncoder(nn.Module):
    """(B, S, H, W, 3) frames -> (B, S-1, v_f_len) frame-pair features.
    ``trunk``: the blocks' (features, kernel, stride, dropout), the flax
    module's ``TRUNK`` field."""

    def __init__(self, cfg: ModelConfig, trunk: Sequence[Tuple[int, int, int, float]] = TRUNK):
        super().__init__()
        self.cfg = cfg
        c_in = 6
        for name, (c_out, k, s, d) in zip(TRUNK_NAMES, trunk, strict=True):
            self.add_module(name, ConvBlock(c_in, c_out, k, s, d, cfg.skip_bn))
            c_in = c_out
        h, w = trunk_out_hw(cfg.img_h, cfg.img_w)
        self.visual_head = nn.Linear(c_in * h * w, cfg.v_f_len)

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, H, W, C = img.shape
        dtype = _dtype(self.cfg)
        pairs = torch.cat([img[:, :-1], img[:, 1:]], dim=-1)
        x = pairs.reshape(B * (S - 1), H, W, 2 * C).to(dtype).permute(0, 3, 1, 2)
        use_kernels = self.cfg.resolved_use_kernels(x.device)
        for name in TRUNK_NAMES:
            x = getattr(self, name)(x, generator, self.cfg.fast_dropout, use_kernels)
        x = x.reshape(B, S - 1, -1)                     # CHW order
        head = self.visual_head
        return F.linear(x, head.weight.to(dtype), head.bias.to(dtype)).float()


class InertialEncoder(nn.Module):
    """(B, 10*(S-1)+1, 6) IMU stream -> (B, S-1, i_f_len) over overlapping
    11-sample windows."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        layers, c_in = [], 6
        for c_out in IMU_CHANNELS:
            layers += [
                nn.Conv1d(c_in, c_out, 3, padding=1),
                nn.Identity() if cfg.skip_bn else nn.BatchNorm1d(c_out, eps=BN_EPS),
                nn.LeakyReLU(0.1),
                nn.Dropout(cfg.imu_dropout),
            ]
            c_in = c_out
        self.encoder_conv = nn.Sequential(*layers)
        self.proj = nn.Linear(c_in * (IMU_FREQ + 1), cfg.i_f_len)

    def forward(self, imu: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, C = imu.shape
        n_win = (N - 1) // IMU_FREQ
        dtype = _dtype(self.cfg)
        idx = (torch.arange(n_win, device=imu.device)[:, None] * IMU_FREQ
               + torch.arange(IMU_FREQ + 1, device=imu.device)[None, :])
        x = imu[:, idx, :].reshape(B * n_win, IMU_FREQ + 1, C).to(dtype)
        x = x.transpose(1, 2)                            # (N, C, L)
        for j in range(len(IMU_CHANNELS)):
            conv, bn, _, drop = self.encoder_conv[4 * j: 4 * j + 4]
            x = F.conv1d(x, conv.weight.to(dtype), _bias(conv, dtype), padding=1)
            if isinstance(bn, nn.BatchNorm1d):
                x = _batchnorm_f32(x, bn)
            x = F.leaky_relu(x.to(dtype), 0.1)
            if self.training:
                x = train_dropout(x, drop.p, generator)
        x = x.reshape(B, n_win, -1)                      # C-major (256, 11)
        proj = self.proj
        return F.linear(x, proj.weight.to(dtype), proj.bias.to(dtype)).float()
