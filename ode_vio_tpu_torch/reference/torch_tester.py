"""Torch replica of the reference DeepVIO + reference eval protocol (the
port's copy of ``ode_vio_tpu/reference/torch_tester.py``, on a device).

Purpose: the one-command parity harness (cli/parity.py) needs a torch-side
"reference implementation" to run the reference's evaluation protocol on a
real checkpoint next to the port's stack. The reference repo itself
depends on torchode/torchcde (not installed), so the architecture is
replicated here with the adaptive dopri5 re-implementation in
:mod:`ode_vio_tpu_torch.reference.torch_odeint` standing in for torchode.
It shares nothing with the port's models: a plain ``nn.Module`` stack run
one (layer, sample) solve at a time.

Fidelity notes (each cites the reference):

* Module names/indices match the reference exactly so a real reference
  ``state_dict`` loads strictly: ``Image_net.conv1.0.weight`` ...
  (src/models/Encoder.py:82-95), ``Inertial_net.encoder_conv.*``
  (Encoder.py:43-57), ``Pose_net.{ode_func.net,fuse.net,rnn,regressor}``
  (PoseODERNN.py:49-68, ODEFunc.py:9-15, FusionModule.py:13-15).
* Eval solves run the training solver configuration — adaptive dopri5,
  atol 1e-6 / rtol 1e-2, dt0 1e-4 refreshed every interval (torchode
  ``evolve_state``, PoseODERNN.py:70-75; ``update_method`` is commented
  out in the reference forward).
* The streaming protocol (windows of stride seq_len-1 sharing one
  boundary frame, carried hidden state, official segment metric) mirrors
  src/data/KITTI_eval.py:78-91,124-160,223-284.

Supported families: ``ode-rnn`` (the flagship / pretrained-weights family)
and ``rnn``.
"""

from __future__ import annotations

import numpy as np

import torch
import torch.nn as nn

from ode_vio_tpu_torch.config import Config, resolve_device
from ode_vio_tpu_torch.data.evaluation import EvalPartition, kitti_eval


def build_reference_model(cfg: Config, device="cuda"):
    """Torch DeepVIO replica for ``cfg.model.model_type`` in
    {'ode-rnn', 'rnn'} whose state_dict layout equals the reference's, in
    eval mode on ``device``."""
    device = resolve_device(device)

    m = cfg.model
    f_len = m.f_len

    def conv_block(ci, co, k, s, dropout):
        # conv(batchNorm=True, ...) Sequential indices (Encoder.py:8-22)
        return nn.Sequential(
            nn.Conv2d(ci, co, k, stride=s, padding=(k - 1) // 2, bias=False),
            nn.BatchNorm2d(co),
            nn.LeakyReLU(0.1),
            nn.Dropout(dropout),
        )

    class ImageNet(nn.Module):
        def __init__(self):
            super().__init__()
            spec = [(6, 64, 7, 2, 0.2), (64, 128, 5, 2, 0.2),
                    (128, 256, 5, 2, 0.2), (256, 256, 3, 1, 0.2),
                    (256, 512, 3, 2, 0.2), (512, 512, 3, 1, 0.2),
                    (512, 512, 3, 2, 0.2), (512, 512, 3, 1, 0.2),
                    (512, 1024, 3, 2, 0.5)]
            names = ["conv1", "conv2", "conv3", "conv3_1", "conv4",
                     "conv4_1", "conv5", "conv5_1", "conv6"]
            for n, sp in zip(names, spec):
                setattr(self, n, conv_block(*sp))
            feat = 1024 * (m.img_h // 64) * (m.img_w // 64)
            self.visual_head = nn.Linear(feat, m.v_f_len)
            self._names = names

        def forward(self, img):  # (B, S, 3, H, W)
            v = torch.cat((img[:, :-1], img[:, 1:]), dim=2)
            B, S1 = v.shape[:2]
            x = v.reshape(B * S1, 6, v.shape[3], v.shape[4])
            for n in self._names:
                x = getattr(self, n)(x)
            return self.visual_head(x.flatten(1)).view(B, S1, -1)

    class InertialNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_conv = nn.Sequential(
                nn.Conv1d(6, 64, 3, padding=1), nn.BatchNorm1d(64),
                nn.LeakyReLU(0.1), nn.Dropout(m.imu_dropout),
                nn.Conv1d(64, 128, 3, padding=1), nn.BatchNorm1d(128),
                nn.LeakyReLU(0.1), nn.Dropout(m.imu_dropout),
                nn.Conv1d(128, 256, 3, padding=1), nn.BatchNorm1d(256),
                nn.LeakyReLU(0.1), nn.Dropout(m.imu_dropout),
            )
            self.proj = nn.Linear(256 * 11, m.i_f_len)

        def forward(self, x):  # (B, 10*(S-1)+1, 6)
            n_win = (x.shape[1] - 1) // 10
            x = torch.stack(
                [x[:, i * 10: i * 10 + 11] for i in range(n_win)], 1)
            B, S1 = x.shape[:2]
            x = x.reshape(B * S1, 11, 6).permute(0, 2, 1)
            x = self.encoder_conv(x)
            return self.proj(x.flatten(1)).view(B, S1, -1)

    def activation():
        return {"tanh": nn.Tanh(), "relu": nn.ReLU(),
                "leaky_relu": nn.LeakyReLU(),
                "softplus": nn.Softplus()}[m.ode_activation_fn]

    class OdeFunc(nn.Module):
        def __init__(self):
            super().__init__()
            layers = [nn.Linear(f_len, m.ode_hidden_dim), activation()]
            for _ in range(m.ode_fn_num_layers - 1):
                layers += [nn.Linear(m.ode_hidden_dim, m.ode_hidden_dim),
                           activation()]
            layers += [nn.Linear(m.ode_hidden_dim, f_len), nn.Tanh()]
            self.net = nn.Sequential(*layers)

        def forward(self, t, x):
            return self.net(x)

    class Fuse(nn.Module):
        def __init__(self):
            super().__init__()
            if m.fuse_method == "soft":
                self.net = nn.Sequential(nn.Linear(f_len, f_len))
            elif m.fuse_method == "hard":
                self.net = nn.Sequential(nn.Linear(f_len, 2 * f_len))

        def forward(self, v, i):
            cat = torch.cat((v, i), -1)
            if m.fuse_method == "cat":
                return cat
            if m.fuse_method == "soft":
                return cat * self.net(cat)
            raise NotImplementedError(
                "hard fusion samples gumbel noise; the parity protocol "
                "needs a deterministic eval path")

    def make_rnn():
        cls = {"rnn": nn.RNN, "gru": nn.GRU}[m.ode_rnn_type]
        return cls(input_size=f_len, hidden_size=f_len,
                   num_layers=m.rnn_num_layers, batch_first=True)

    sol = cfg.solver

    class PoseNet(nn.Module):
        def __init__(self, with_ode: bool):
            super().__init__()
            if with_ode:
                self.ode_func = OdeFunc()
            self.rnn = make_rnn()
            self.fuse = Fuse()
            self.regressor = nn.Sequential(
                nn.Linear(f_len, 128), nn.LeakyReLU(0.1), nn.Linear(128, 6))
            self._with_ode = with_ode

        def _evolve(self, h, t0, t1):
            """One interval per (layer, sample): adaptive dopri5 at the
            reference tolerances with dt0 refreshed per call, exactly like
            torchode's evolve_state (PoseODERNN.py:70-75). Fixed-step
            methods mirror the solver config for toy parity runs."""
            from ode_vio_tpu_torch.reference.torch_odeint import odeint_dopri5

            out = torch.zeros_like(h)
            L, B = h.shape[:2]
            if not sol.adaptive:
                for b in range(B):
                    dt = (t1[b] - t0[b]) / sol.fixed_steps
                    y = h[:, b]
                    for _ in range(sol.fixed_steps):
                        y = y + dt * self.ode_func(None, y)
                    out[:, b] = y
                return out
            for l in range(L):
                for b in range(B):
                    y, _, _, _ = odeint_dopri5(
                        lambda t, y: self.ode_func(t, y),
                        h[l, b], float(t0[b]), float(t1[b]),
                        rtol=sol.rtol, atol=sol.atol, dt0=sol.dt0,
                        max_steps=sol.max_steps, safety=sol.safety,
                        factor_min=sol.factor_min, factor_max=sol.factor_max,
                    )
                    out[l, b] = y
            return out

        def forward(self, fv, fi, ts, hc=None):
            fused = self.fuse(fv, fi)
            B, steps, _ = fused.shape
            h = (torch.zeros(m.rnn_num_layers, B, f_len, device=fused.device)
                 if hc is None else hc)
            ts = ts - ts[:, :1] if hc is None else ts  # PoseODERNN.py:100
            outs = []
            for i in range(steps):
                if self._with_ode:
                    h = self._evolve(h, ts[:, i], ts[:, i + 1])
                out_i, h = self.rnn(fused[:, i: i + 1], h)
                outs.append(out_i)
            return self.regressor(torch.cat(outs, 1)), h

    class DeepVIORef(nn.Module):
        def __init__(self):
            super().__init__()
            self.Image_net = ImageNet()
            self.Inertial_net = InertialNet()
            self.Pose_net = PoseNet(with_ode=m.model_type == "ode-rnn")

        def forward(self, img, imu, ts, hc=None):
            fv = self.Image_net(img)
            fi = self.Inertial_net(imu)
            return self.Pose_net(fv, fi, ts, hc=hc)

    if m.model_type not in ("ode-rnn", "rnn"):
        raise ValueError(
            f"torch protocol tester supports ode-rnn/rnn, got "
            f"{m.model_type!r}")
    return DeepVIORef().to(device).eval()


def load_state(model, sd) -> None:
    """Strict-load a reference state_dict (torch file dict or numpy dict;
    ``num_batches_tracked`` buffers are optional)."""
    tensors = {
        k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
        for k, v in sd.items()
    }
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if "num_batches_tracked" not in k]
    if missing or unexpected:
        raise ValueError(
            f"state_dict mismatch: missing={missing[:5]} "
            f"unexpected={list(unexpected)[:5]}")


def protocol_eval(model, part: EvalPartition, device="cuda") -> dict:
    """The reference KITTI_tester protocol (KITTI_eval.py:124-200) on one
    sequence: stream windows with carried hidden state, stack predictions,
    score the official segment metric. ``part`` supplies exactly the same
    decoded windows the port's tester consumes, so a parity delta isolates
    the MODEL stacks (not the data pipeline). Runs on ``device``, where
    ``model`` lies."""
    device = resolve_device(device)
    hc = None
    preds = []
    for i in range(len(part)):
        w = part[i]
        imgs = torch.from_numpy(
            np.ascontiguousarray(w.imgs.transpose(0, 3, 1, 2)))[None].to(device)
        imu = torch.from_numpy(w.imus)[None].to(device)
        ts = torch.from_numpy(w.ts)[None].to(device)
        with torch.no_grad():
            poses, hc = model(imgs, imu, ts, hc=hc)
        preds.append(poses[0, : w.valid].cpu().numpy())
    pose_est = np.concatenate(preds, 0)
    gt = np.asarray(part.seq.rel_poses[: len(pose_est)], np.float32)
    return kitti_eval(pose_est, gt)
