"""DeepVIO, the top-level visual-inertial odometry model (counterpart of
``ode_vio_tpu/models/deepvio.py``).

Shape contract, the JAX package's layout:
    img (B, S, H, W, 3), imu (B, 10*(S-1)+1, 6), ts (B, S)
    -> poses (B, S-1, 6), carry (L, B, F), SolveStats

Submodules carry the reference names (``Image_net``, ``Inertial_net``,
``Pose_net``), so ``state_dict()`` is in the reference layout that
``ode_vio_tpu/models/convert.py::export_deepvio`` writes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_vio_tpu_torch.config import Config, ModelConfig, SolverConfig, resolve_device
from ode_vio_tpu_torch.models.common import init_weights
from ode_vio_tpu_torch.models.encoders import ImageEncoder, InertialEncoder
from ode_vio_tpu_torch.models.pose_odernn import PoseODERNN

POSE_CORES = ("ode-rnn", "rnn", "cde", "rde", "cfc", "ltc")


class DeepVIO(nn.Module):
    def __init__(self, cfg: ModelConfig, solver: SolverConfig = SolverConfig()):
        super().__init__()
        mt = cfg.model_type
        if mt not in POSE_CORES:
            raise ValueError(f"model_type '{mt}' not supported; choose from {POSE_CORES}")
        if mt != "ode-rnn":
            raise NotImplementedError(
                f"the '{mt}' pose core is not ported yet (ROADMAP.md, "
                "Queue 1 item 6: other pose cores)")
        self.cfg = cfg
        self.solver = solver
        self.Image_net = ImageEncoder(cfg)
        self.Inertial_net = InertialEncoder(cfg)
        self.Pose_net = PoseODERNN(cfg, solver)

    def forward(self, img: torch.Tensor, imu: torch.Tensor, ts: torch.Tensor,
                hc: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        fv = self.Image_net(img)
        fi = self.Inertial_net(imu)
        return self.Pose_net(fv, fi, ts, prev=hc, generator=generator)


def create_model(config: Config, *, seed: int = 0, device="cuda") -> DeepVIO:
    """Build DeepVIO in eval mode on ``device`` with the reference's init
    drawn from a CPU ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    model = DeepVIO(config.model, config.solver)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
