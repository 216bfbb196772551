"""The plain reference of the DeepVIO models the benchmark runs.

Written from the ODE-VIO model's equations, with TF32 off and no kernels
or caches; it reads the weights by their reference names (``Image_net.*``,
``Inertial_net.*``, ``Pose_net.*``) from a plain dict of tensors, the
same dict the benchmark hands to the measured program.

Precision, as the configuration states it: the encoders compute in the
model's ``compute_dtype`` (bf16 in every cell), that is, each input,
weight and output of a layer is a ``compute_dtype`` value and the sums
behind each output are float32 (convolutions and products in float32 on
the rounded values, their results rounded); with ``fold_bn`` (the
mixes' BatchNorm folding) each BatchNorm is first folded into its
convolution's weight and bias in float32, as any folding of frozen
statistics gives them. The pose core (fusion, ODE field, RNN, solver,
regressor) computes in float32.

* Visual encoder: each frame pair's two RGB frames stacked to 6 channels;
  nine FlowNet-S convolutions (padding (k-1)/2, no bias), each followed by
  BatchNorm with its running statistics and LeakyReLU(0.1); the (C, H, W)
  output flattened and projected to ``v_f_len``.
* Inertial encoder: the 11 IMU samples around each frame interval (stride
  10), three Conv1d(k=3, pad 1) + BatchNorm + LeakyReLU(0.1) layers, the
  (C, L) output flattened and projected to ``i_f_len``.
* Soft fusion: ``feat * (W feat + b)`` on the concatenated features.
* ode-rnn: per frame interval the hidden state of every RNN layer evolves
  under ``dh/dt = MLP(h)`` (activation, then tanh out), solved by
  :mod:`dopri5` with the step proposal carried from interval to interval
  (``dt0`` at a window's start); then the tanh RNN stack takes the fused
  features; the top layer's output regresses to the pose.
* rnn: the same without the solve.
* cde: the fused features reduced to ``cde_hidden_dim`` and prefixed with
  their time are the knots of a linear path; ``dz = g(z) dX`` through the
  knots, segment by segment, each with its own step budget; ``z0`` is
  ``tanh(W obs_0 + b)`` on a cold start. The path's slope at a knot is the
  next segment's.
* Pose regressor: Linear(128), LeakyReLU(0.1), Linear(6).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vio_bench.reference import dopri5

TRUNK = (("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
         ("conv3_1", 256, 3, 1), ("conv4", 512, 3, 2), ("conv4_1", 512, 3, 1),
         ("conv5", 512, 3, 2), ("conv5_1", 512, 3, 1), ("conv6", 1024, 3, 2))
IMU_CHANNELS = (64, 128, 256)
IMU_FREQ = 10
BN_EPS = 1e-5
PAIRS_PER_BLOCK = 40


def trunk_out_hw(h: int, w: int):
    for _, _, _, s in TRUNK:
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
    return h, w


def softplus(x):
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu, "softplus": softplus,
               "leaky_relu": lambda x: F.leaky_relu(x, 0.01)}


class ReferenceModel:
    """One window at a time for a batch of sessions: :meth:`window` maps
    (img, imu, ts, carry) to (poses, carry, field evaluations)."""

    def __init__(self, model: dict, solver: dict, cde_solver: dict,
                 weights: Dict[str, torch.Tensor], fold_bn: bool = False,
                 encoders: Optional[str] = None, core: Optional[str] = None):
        self.m = model
        self.dtype = torch.float32
        # the encoders' precision: the configuration's, or a control's
        # ("float8_e4m3fn": the precision below bf16)
        self.enc = getattr(torch, encoders or model["compute_dtype"])
        # the pose core's products: float32 as stated, or a control's
        # ("bfloat16": operands and results rounded; "tf32": operands
        # rounded to TF32's 10-bit mantissa, float32 results)
        if core not in (None, "float32", "bfloat16", "tf32"):
            raise ValueError(f"the reference has no {core} pose core")
        self.core_in = None if core == "float32" else core
        self.w = {k: v.to(self.dtype) for k, v in weights.items() if v.is_floating_point()}
        self.fold_bn = fold_bn
        if fold_bn:
            self.w.update(_folded(self.w))
        self.ode_ctl = dopri5.Controller(solver["rtol"], solver["atol"], solver["max_steps"],
                                         solver["safety"], solver["factor_min"],
                                         solver["factor_max"])
        self.ode_dt0 = solver["dt0"]
        self.cde_ctl = dopri5.Controller(cde_solver["rtol"], cde_solver["atol"],
                                         cde_solver["max_steps"], cde_solver["safety"],
                                         cde_solver["factor_min"], cde_solver["factor_max"])
        self.cde_dt0 = cde_solver["dt0"]

    # -- encoders ------------------------------------------------------------
    def _r(self, x):
        """``x`` rounded to the encoders' precision (saturating where that
        is a float8), as float32."""
        if self.enc == x.dtype:
            return x
        if self.enc.itemsize == 1:
            top = torch.finfo(self.enc).max
            x = x.clamp(-top, top)
        return x.to(self.enc).to(x.dtype)

    def _block(self, conv, x, w_name, b_name, bn_name, **kw):
        """One convolution with its BatchNorm (folded or not) and
        LeakyReLU(0.1), every value in the encoders' precision."""
        r = self._r
        b = self.w.get(b_name)
        x = r(conv(x, r(self.w[w_name]), None if b is None else r(b), **kw))
        if not self.fold_bn:
            x = r(self._bn(x, bn_name))
        return r(F.leaky_relu(x, 0.1))

    def _bn(self, x, name):
        w = self.w
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] + BN_EPS)
        return ((x - w[f"{name}.running_mean"].reshape(shape)) * scale.reshape(shape)
                + w[f"{name}.bias"].reshape(shape))

    def _trunk(self, x):
        for name, _, k, s in TRUNK:
            p = f"Image_net.{name}"
            x = self._block(F.conv2d, x, f"{p}.0.weight", f"{p}.0.bias", f"{p}.1",
                            stride=s, padding=(k - 1) // 2)
        return x.flatten(1)

    def image_features(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, S, H, W, 3) -> (B, S-1, v_f_len)."""
        B, S, H, W, _ = img.shape
        r = self._r
        pairs = torch.cat([img[:, :-1], img[:, 1:]], -1).reshape(B * (S - 1), H, W, 6)
        flat = torch.cat([self._trunk(r(pairs[i:i + PAIRS_PER_BLOCK].to(self.dtype))
                                      .permute(0, 3, 1, 2))
                          for i in range(0, pairs.shape[0], PAIRS_PER_BLOCK)])
        out = r(F.linear(flat, r(self.w["Image_net.visual_head.weight"]),
                         r(self.w["Image_net.visual_head.bias"])))
        return out.reshape(B, S - 1, -1)

    def imu_features(self, imu: torch.Tensor) -> torch.Tensor:
        """imu (B, 10(S-1)+1, 6) -> (B, S-1, i_f_len)."""
        B, N, _ = imu.shape
        n = (N - 1) // IMU_FREQ
        idx = (torch.arange(n, device=imu.device)[:, None] * IMU_FREQ
               + torch.arange(IMU_FREQ + 1, device=imu.device))
        r = self._r
        x = r(imu.to(self.dtype)[:, idx].reshape(B * n, IMU_FREQ + 1, 6).transpose(1, 2))
        for j in range(len(IMU_CHANNELS)):
            p = "Inertial_net.encoder_conv"
            x = self._block(F.conv1d, x, f"{p}.{4 * j}.weight", f"{p}.{4 * j}.bias",
                            f"{p}.{4 * j + 1}", padding=1)
        x = x.reshape(B, n, -1)
        return r(F.linear(x, r(self.w["Inertial_net.proj.weight"]),
                          r(self.w["Inertial_net.proj.bias"])))

    # -- pose cores ----------------------------------------------------------
    def _c(self, x):
        """A pose-core operand in the core's precision."""
        if self.core_in == "bfloat16":
            return x.to(torch.bfloat16).to(x.dtype)
        if self.core_in == "tf32":
            return _round_tf32(x)
        return x

    def _out(self, x):
        """A pose-core product's result in the core's precision."""
        return x.to(torch.bfloat16).to(x.dtype) if self.core_in == "bfloat16" else x

    def _linear(self, x, name):
        c = self._c
        return self._out(F.linear(c(x), c(self.w[f"{name}.weight"]), c(self.w[f"{name}.bias"])))

    def _mlp(self, prefix: str, n_layers: int, act, x):
        for i in range(n_layers):
            x = self._linear(x, f"{prefix}.{2 * i}")
            x = act(x) if i < n_layers - 1 else torch.tanh(x)
        return x

    def _regress(self, x):
        return self._linear(F.leaky_relu(self._linear(x, "Pose_net.regressor.0"), 0.1),
                            "Pose_net.regressor.2")

    def _rnn_step(self, x, h):
        new = []
        for l in range(self.m["rnn_num_layers"]):
            p = "Pose_net.rnn."
            c, w = self._c, self.w
            x = torch.tanh(self._out(c(x) @ c(w[f"{p}weight_ih_l{l}"]).T)
                           + self._out(c(h[l]) @ c(w[f"{p}weight_hh_l{l}"]).T)
                           + w[f"{p}bias_ih_l{l}"] + w[f"{p}bias_hh_l{l}"])
            new.append(x)
        return x, torch.stack(new)

    def _recurrent(self, fused, ts, carry, solve: bool):
        B, steps, Fd = fused.shape
        L = self.m["rnn_num_layers"]
        h = fused.new_zeros(L, B, Fd) if carry is None else carry.to(self.dtype)
        act = ACTIVATIONS[self.m["ode_activation_fn"]]
        n_layers = self.m["ode_fn_num_layers"] + 1
        field = lambda t, y: self._mlp("Pose_net.ode_func.net", n_layers, act, y)  # noqa: E731
        dt = torch.full((L * B,), self.ode_dt0, dtype=torch.float32, device=fused.device)
        evals, outs = 0, []
        for k in range(steps):
            y = h.reshape(L * B, Fd)
            if solve:
                y, dt, _, _, n = dopri5.solve(field, y, ts[:, k].repeat(L).to(self.dtype),
                                              ts[:, k + 1].repeat(L).to(self.dtype),
                                              dt.to(self.dtype), self.ode_ctl)
                evals += n
            out, h = self._rnn_step(fused[:, k], y.reshape(L, B, Fd))
            outs.append(out)
        return self._regress(torch.stack(outs, 1)), h, evals

    def _cde(self, fused, ts, carry, cold):
        H = self.m["cde_hidden_dim"]
        x = self._linear(F.leaky_relu(self._linear(fused, "Pose_net.reduction_net.0"), 0.1),
                         "Pose_net.reduction_net.2")
        ts = ts.to(self.dtype)
        ts_eff = torch.where(cold[:, None], ts - ts[:, :1], ts)
        knots = ts_eff[:, 1:]
        obs = torch.cat([knots[..., None], x], -1)
        z_init = torch.tanh(self._linear(obs[:, 0], "Pose_net.initial.0"))
        z = z_init if carry is None else torch.where(cold[:, None], z_init, carry.to(self.dtype))
        gap = knots[:, 1:] - knots[:, :-1]
        slope = (obs[:, 1:] - obs[:, :-1]) / torch.where(gap > 0, gap, torch.ones_like(gap))[..., None]
        act = ACTIVATIONS[self.m["cde_activation_fn"]]
        n_layers = self.m["cde_fn_num_layers"] + 1
        rows = torch.arange(z.shape[0], device=z.device)

        def field(t, zz):
            seg = ((knots <= t[:, None]).sum(-1) - 1).clamp(0, knots.shape[1] - 2)
            g = self._mlp("Pose_net.cde_func.net", n_layers, act, zz).reshape(-1, H, H + 1)
            return self._out(self._c(g) @ self._c(slope[rows, seg][..., None]))[..., 0]

        through = torch.cat([knots[:, :1], knots], 1)
        dt = torch.full((z.shape[0],), self.cde_dt0, dtype=self.dtype, device=z.device)
        zs, evals = [], 0
        for j in range(through.shape[1] - 1):
            z, dt, _, _, n = dopri5.solve(field, z, through[:, j], through[:, j + 1], dt,
                                          self.cde_ctl)
            zs.append(z)
            evals += n
        zs = torch.stack(zs, 1)
        return self._regress(zs), zs[:, -1], evals

    def features(self, img, imu):
        """The encoders: (visual (B, S-1, v_f_len), inertial (B, S-1, i_f_len))."""
        return self.image_features(img), self.imu_features(imu)

    def core(self, fv, fi, ts, carry: Optional[torch.Tensor] = None,
             cold: Optional[torch.Tensor] = None):
        """Fusion, the pose core and the regressor from the features:
        (poses (B, S-1, 6), the next carry, field evaluations)."""
        feat = torch.cat([fv, fi], -1).to(self.dtype)   # float32 from here on
        if self.m["fuse_method"] == "soft":
            feat = feat * self._linear(feat, "Pose_net.fuse.net.0")
        elif self.m["fuse_method"] != "cat":
            raise ValueError(f"the reference has no {self.m['fuse_method']} fusion")
        kind = self.m["model_type"]
        if kind in ("ode-rnn", "rnn"):
            return self._recurrent(feat, ts.to(self.dtype), carry, kind == "ode-rnn")
        if kind == "cde":
            if cold is None:
                cold = torch.full((feat.shape[0],), carry is None, device=feat.device)
            return self._cde(feat, ts, carry, cold)
        raise ValueError(f"the reference has no {kind} core")

    def window(self, img, imu, ts, carry: Optional[torch.Tensor] = None,
               cold: Optional[torch.Tensor] = None):
        """Poses (B, S-1, 6), the next carry and the field evaluations of
        one window per row. ``ts`` (B, S) on each session's clock;
        ``cold`` (B,) marks rows whose cde state starts from the first
        observation rather than from ``carry``."""
        return self.core(*self.features(img, imu), ts, carry, cold)


def _folded(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each BatchNorm folded into its convolution (``<base>.<i>`` into
    ``<base>.<i-1>``): kernel ``W s`` and bias ``(b - mean) s + beta``
    with ``s = gamma / sqrt(var + eps)``, the square root correctly rounded
    in float32."""
    out = {}
    for key in w:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        base, idx = bn.rsplit(".", 1)
        conv = f"{base}.{int(idx) - 1}"
        s = w[f"{bn}.weight"] / torch.sqrt((w[f"{bn}.running_var"] + BN_EPS).double()).float()
        kernel = w[f"{conv}.weight"]
        out[f"{conv}.weight"] = kernel * s.reshape((-1,) + (1,) * (kernel.dim() - 1))
        b0 = w.get(f"{conv}.bias", torch.zeros_like(s))
        out[f"{conv}.bias"] = (b0 - w[f"{bn}.running_mean"]) * s + w[f"{bn}.bias"]
    return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero, as the tensor cores take their operands)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def param_specs(model: dict) -> List[tuple]:
    """``(name, shape, init)`` of every tensor of the model's state dict, in
    the reference layout; ``init`` is ``("normal", std)`` (Kaiming normal,
    fan-in, gain sqrt 2), ``("uniform", bound)``, ``("const", value)``
    or ``("count", 0)`` (BatchNorm's int64 counter)."""
    specs = []

    def linear(name, n_out, n_in, bias=True):
        specs.append((f"{name}.weight", (n_out, n_in), ("normal", math.sqrt(2.0 / n_in))))
        if bias:
            specs.append((f"{name}.bias", (n_out,), ("const", 0.0)))

    def bn(name, c):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)),
                      (f"{name}.bias", (c,), ("const", 0.0)),
                      (f"{name}.running_mean", (c,), ("const", 0.0)),
                      (f"{name}.running_var", (c,), ("const", 1.0)),
                      (f"{name}.num_batches_tracked", (), ("count", 0))])

    c_in = 6
    for name, c_out, k, _ in TRUNK:
        fan = c_in * k * k
        specs.append((f"Image_net.{name}.0.weight", (c_out, c_in, k, k),
                      ("normal", math.sqrt(2.0 / fan))))
        bn(f"Image_net.{name}.1", c_out)
        c_in = c_out
    h, w = trunk_out_hw(model["img_h"], model["img_w"])
    linear("Image_net.visual_head", model["v_f_len"], c_in * h * w)
    c_in = 6
    for j, c_out in enumerate(IMU_CHANNELS):
        specs.append((f"Inertial_net.encoder_conv.{4 * j}.weight", (c_out, c_in, 3),
                      ("normal", math.sqrt(2.0 / (c_in * 3)))))
        specs.append((f"Inertial_net.encoder_conv.{4 * j}.bias", (c_out,), ("const", 0.0)))
        bn(f"Inertial_net.encoder_conv.{4 * j + 1}", c_out)
        c_in = c_out
    linear("Inertial_net.proj", model["i_f_len"], c_in * (IMU_FREQ + 1))
    f = model["v_f_len"] + model["i_f_len"]
    if model["fuse_method"] == "soft":
        linear("Pose_net.fuse.net.0", f, f)
    kind = model["model_type"]
    if kind == "ode-rnn":
        sizes = [f] + [model["ode_hidden_dim"]] * model["ode_fn_num_layers"] + [f]
        for i in range(len(sizes) - 1):
            linear(f"Pose_net.ode_func.net.{2 * i}", sizes[i + 1], sizes[i])
    if kind in ("ode-rnn", "rnn"):
        bound = 1.0 / math.sqrt(f)
        for l in range(model["rnn_num_layers"]):
            for part, shape in (("weight_ih", (f, f)), ("weight_hh", (f, f)),
                                ("bias_ih", (f,)), ("bias_hh", (f,))):
                specs.append((f"Pose_net.rnn.{part}_l{l}", shape, ("uniform", bound)))
        linear("Pose_net.regressor.0", 128, f)
    elif kind == "cde":
        H = model["cde_hidden_dim"]
        linear("Pose_net.reduction_net.0", f // 2, f)
        linear("Pose_net.reduction_net.2", H, f // 2)
        sizes = [H] + [H] * model["cde_fn_num_layers"] + [H * (H + 1)]
        for i in range(len(sizes) - 1):
            linear(f"Pose_net.cde_func.net.{2 * i}", sizes[i + 1], sizes[i])
        linear("Pose_net.initial.0", H, H + 1)
        linear("Pose_net.regressor.0", 128, H)
    else:
        raise ValueError(f"the reference has no {kind} core")
    linear("Pose_net.regressor.2", 6, 128)
    return specs
