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

Two rewrites of the conv trunk, as in JAX, with the parameters unchanged:
``encoder_s2d`` computes the stride-2 convs with at most 64 input channels
as space-to-depth plus a stride-1 conv (:func:`s2d_conv`, exact), in train
and eval; ``encoder_int8`` runs every trunk conv at eval through
:func:`int8_conv`: int8 weights and activations, their products summed
exactly in int32 (on the card an int8 im2col and ``torch._int_mm``, the
int8 GEMM of cuBLASLt; XLA computed this conv outside any Pallas kernel).
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


def _s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """The (O, 4C, kh, kh) kernel, kh = (k+2)//2, of the stride-1 conv over
    ``F.pixel_unshuffle(x, 2)`` (channel ``c*4 + ry*2 + rx`` holds
    ``x[c, 2p+ry, 2q+rx]``) that equals the stride-2 conv of ``x`` with the
    odd (O, C, k, k) kernel ``w`` at padding (k-1)//2. Tap ``a`` of phase
    ``r`` is ``w``'s tap ``2(a-A) + r + P`` (P = (k-1)//2, A = (P+1)//2),
    zero where that falls off the kernel; slices of ``w``, so gradients
    reach it."""
    O, C, k, _ = w.shape
    P, kh = (k - 1) // 2, (k + 2) // 2
    A = (P + 1) // 2
    wp = F.pad(w, (1, 1, 1, 1))  # the taps off the kernel, -1 and k, read zeros
    first = [r + P - 2 * A + 1 for r in (0, 1)]  # padded index of tap a = 0
    phases = [torch.stack([wp[:, :, first[ry]::2, first[rx]::2][:, :, :kh, :kh]
                           for rx in (0, 1)], 2) for ry in (0, 1)]
    return torch.stack(phases, 2).reshape(O, 4 * C, kh, kh)


def s2d_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stride-2 conv of ``x`` (B, C, H, W; H and W even) with the odd
    kernel ``w`` at padding (k-1)//2, as space-to-depth and a stride-1 conv
    (JAX ``_space_to_depth_conv``): exact, padded ``A`` before and
    ``kh-1-A`` after."""
    k = w.shape[-1]
    P, kh = (k - 1) // 2, (k + 2) // 2
    A = (P + 1) // 2
    x2 = F.pad(F.pixel_unshuffle(x, 2), (A, kh - 1 - A, A, kh - 1 - A))
    return F.conv2d(x2, _s2d_weight(w).to(x.dtype))


def quantize_weight(w: torch.Tensor):
    """Symmetric int8 per output channel: ``(kq, kscale)`` with
    ``kscale = max(max|w[o]|, 1e-8) / 127`` and ``kq = clip(round(w /
    kscale), -127, 127)``; ``round`` is half to even, as ``jnp.round``."""
    kscale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-8) / 127.0
    kq = torch.clamp(torch.round(w / kscale.reshape(-1, 1, 1, 1)), -127, 127)
    return kq.to(torch.int8), kscale


def quantize_activation(x: torch.Tensor):
    """Symmetric int8 with one dynamic scale per batch element, over (C, H,
    W), in ``x``'s dtype: co-batched serving lanes stay independent."""
    ascale = torch.clamp_min(x.abs().amax(dim=(1, 2, 3), keepdim=True), 1e-8) / 127.0
    xq = torch.clamp(torch.round(x.float() / ascale), -127, 127)
    return xq.to(torch.int8), ascale


def int8_accumulate_plain(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                          pad: int) -> torch.Tensor:
    """The int32 sums of the int8 conv (B, O, Ho, Wo): a float64 conv of
    the integer values, exact since every sum is below 127^2 * 4,608 <
    2^53, rounded (any conv algorithm lands within 0.5) and cast."""
    acc = F.conv2d(xq.double(), kq.double(), stride=stride, padding=pad)
    return acc.round().to(torch.int32)


def int8_gemm_operands(xq: torch.Tensor, kq: torch.Tensor, stride: int, pad: int):
    """The int8 GEMM of the conv: ``(a, b, (B, Ho, Wo))`` with ``a`` the
    padded input's patches, taken with ``Tensor.unfold`` views and copied
    once into (B*Ho*Wo, C*k*k) rows (c, dy, dx order), and ``b`` the
    (O, C*k*k) kernel; K padded with zero columns to a multiple of 8 and M
    with zero rows past 16, as ``torch._int_mm`` requires."""
    O, C, k, _ = kq.shape
    cols = F.pad(xq, (pad, pad, pad, pad)).unfold(2, k, stride).unfold(3, k, stride)
    B, _, Ho, Wo = cols.shape[:4]
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(B * Ho * Wo, C * k * k)
    b = kq.reshape(O, C * k * k)
    M, K = a.shape
    pad_k, pad_m = -K % 8, max(17 - M, 0)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
        b = F.pad(b, (0, pad_k))
    return a, b, (B, Ho, Wo)


def int8_accumulate(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                    pad: int) -> torch.Tensor:
    """:func:`int8_accumulate_plain`'s sums. On a CUDA tensor: the
    :func:`int8_gemm_operands` through ``torch._int_mm`` (int32 out), each
    GEMM counted in ``int8_accumulate.launches``. On a CPU tensor: the
    plain version."""
    if xq.device.type == "cpu":
        return int8_accumulate_plain(xq, kq, stride, pad)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_accumulate runs on cuda or cpu, not {xq.device}")
    if xq.dtype != torch.int8 or kq.dtype != torch.int8 or kq.shape[0] % 8:
        raise ValueError(f"int8_accumulate takes int8 tensors and a multiple of 8 output "
                         f"channels, got {xq.dtype}, {kq.dtype}, O={kq.shape[0]}")
    a, b, (B, Ho, Wo) = int8_gemm_operands(xq, kq, stride, pad)
    acc = torch._int_mm(a, b.t())
    int8_accumulate.launches += 1
    return acc[:B * Ho * Wo].reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2)


int8_accumulate.launches = 0


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
              use_kernels: bool) -> torch.Tensor:
    """The eval-time int8 conv (JAX ``_int8_conv``): ``w`` quantized per
    output channel, ``x`` per batch element, the int32 sums scaled back by
    ``ascale * kscale`` (that product first) in float32 and cast to
    ``x``'s dtype. ``use_kernels``: the sums through
    :func:`int8_accumulate`, else its plain version."""
    kq, kscale = quantize_weight(w.float())
    xq, ascale = quantize_activation(x)
    accumulate = int8_accumulate if use_kernels else int8_accumulate_plain
    acc = accumulate(xq, kq, stride, pad)
    return (acc.float() * (ascale * kscale.reshape(1, -1, 1, 1))).to(x.dtype)


class ConvBlock(nn.Sequential):
    """Conv2d (symmetric padding) + BatchNorm + LeakyReLU(0.1) + Dropout,
    at the reference indices 0..3. ``s2d``: the conv as :func:`s2d_conv`
    where its stride is 2 and the input's H and W are even; ``int8``: at
    eval, as :func:`int8_conv` (``s2d`` then does not apply)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 dropout: float, skip_bn: bool = False, s2d: bool = False,
                 int8: bool = False):
        super().__init__(
            nn.Conv2d(c_in, c_out, kernel, stride=stride,
                      padding=(kernel - 1) // 2, bias=skip_bn),
            nn.Identity() if skip_bn else nn.BatchNorm2d(c_out, eps=BN_EPS),
            nn.LeakyReLU(0.1),
            nn.Dropout(dropout),
        )
        self.s2d, self.int8 = s2d, int8

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                fast_dropout: bool = True, use_kernels: bool = False) -> torch.Tensor:
        conv, bn = self[0], self[1]
        dtype = x.dtype
        if self.int8 and not self.training:
            x = int8_conv(x, conv.weight, conv.stride[0], conv.padding[0], use_kernels)
        elif self.s2d and conv.stride[0] == 2 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            x = s2d_conv(x, conv.weight.to(dtype))
        else:
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
        # the folded graph without BatchNorm (skip_bn) keeps the plain conv, as in JAX
        variant = not cfg.skip_bn
        for name, (c_out, k, s, d) in zip(TRUNK_NAMES, trunk, strict=True):
            s2d = variant and cfg.encoder_s2d and s == 2 and c_in <= 64
            self.add_module(name, ConvBlock(c_in, c_out, k, s, d, cfg.skip_bn, s2d,
                                            variant and cfg.encoder_int8))
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
