"""DeepVIO, the top-level visual-inertial odometry model (counterpart of
``ode_vio_tpu/models/deepvio.py``).

Shape contract, the JAX package's layout:
    img (B, S, H, W, 3), imu (B, 10*(S-1)+1, 6), ts (B, S)
    -> poses (B, S-1, 6), carry, SolveStats

The carry is the pose core's: (L, B, F) for ode-rnn; (B, H) for cde and
rde, or in their history mode a dict of (B, ...) tensors.
:attr:`DeepVIO.carry_lane_axis` is the axis of its leaves that indexes
the batch lanes.

Submodules carry the reference names (``Image_net``, ``Inertial_net``,
``Pose_net``), so ``state_dict()`` is in the reference layout that
``ode_vio_tpu/models/convert.py::export_deepvio`` writes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import Config, ModelConfig, SolverConfig, resolve_device
from ode_vio_tpu_torch.models.common import Carry, init_weights
from ode_vio_tpu_torch.models.encoders import ImageEncoder, InertialEncoder
from ode_vio_tpu_torch.models.pose_cde import PoseCDE
from ode_vio_tpu_torch.models.pose_odernn import PoseODERNN
from ode_vio_tpu_torch.models.pose_rde import PoseRDE

POSE_CORES = ("ode-rnn", "rnn", "cde", "rde", "cfc", "ltc")


class DeepVIO(nn.Module):
    def __init__(self, cfg: ModelConfig, solver: SolverConfig = SolverConfig(),
                 cde_solver: SolverConfig = SolverConfig(rtol=1e-4, atol=1e-6)):
        super().__init__()
        mt = cfg.model_type
        if mt not in POSE_CORES:
            raise ValueError(f"model_type '{mt}' not supported; choose from {POSE_CORES}")
        if mt in ("rnn", "cfc", "ltc"):
            raise NotImplementedError(
                f"the '{mt}' pose core is not ported yet (ROADMAP.md, "
                "Queue 1 item 6: other pose cores)")
        self.cfg = cfg
        self.solver = solver
        self.cde_solver = cde_solver
        self.Image_net = ImageEncoder(cfg)
        self.Inertial_net = InertialEncoder(cfg)
        if mt == "ode-rnn":
            self.Pose_net = PoseODERNN(cfg, solver)
        else:
            self.Pose_net = (PoseCDE if mt == "cde" else PoseRDE)(cfg, cde_solver)

    @property
    def carry_lane_axis(self) -> int:
        return self.Pose_net.carry_lane_axis

    def forward(self, img: torch.Tensor, imu: torch.Tensor, ts: torch.Tensor,
                hc: Optional[Carry] = None,
                generator: Optional[torch.Generator] = None):
        """``generator``: the randomness of train-mode dropout and of hard
        fusion's Gumbel noise."""
        fv = self.Image_net(img, generator)
        return self.pose_from_visual(fv, imu, ts, hc, generator)

    def encode(self, img: torch.Tensor, imu: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """The two encoders alone: (visual, inertial) features."""
        return self.Image_net(img, generator), self.Inertial_net(imu, generator)

    def pose_from_visual(self, fv: torch.Tensor, imu: torch.Tensor, ts: torch.Tensor,
                         hc: Optional[Carry] = None,
                         generator: Optional[torch.Generator] = None):
        """The forward from visual features ``fv`` computed elsewhere (the
        frozen image encoder's inference graph in the ``frozen_encoder_eval``
        train step): the inertial encoder and the pose core."""
        fi = self.Inertial_net(imu, generator)
        return self.Pose_net(fv, fi, ts, prev=hc, generator=generator)


def create_model(config: Config, *, seed: int = 0, device="cuda",
                 train: bool = False) -> DeepVIO:
    """Build DeepVIO on ``device`` with the reference's init drawn from a
    CPU ``torch.Generator`` seeded with ``seed``, in eval mode, or in train
    mode with ``train``."""
    device = resolve_device(device)
    model = DeepVIO(config.model, config.solver, config.cde_solver_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
