"""DeepVIO, the top-level visual-inertial odometry model (counterpart of
``ode_vio_tpu/models/deepvio.py``).

Shape contract, the JAX package's layout:
    img (B, S, H, W, 3), imu (B, 10*(S-1)+1, 6), ts (B, S)
    -> poses (B, S-1, 6), carry, SolveStats

The carry is the pose core's: (L, B, F) for ode-rnn and rnn; (B, H) for
cde, rde, cfc and ltc, or in the cde/rde history mode a dict of (B, ...)
tensors.
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
from ode_vio_tpu_torch.models.pose_ncp import PoseNCP
from ode_vio_tpu_torch.models.pose_odernn import PoseODERNN
from ode_vio_tpu_torch.models.pose_rde import PoseRDE
from ode_vio_tpu_torch.models.pose_rnn import PoseRNN

POSE_CORES = ("ode-rnn", "rnn", "cde", "rde", "cfc", "ltc")


def require_ported(model_type: str) -> None:
    """Raise ValueError for a pose core the JAX package lacks."""
    if model_type not in POSE_CORES:
        raise ValueError(f"model_type '{model_type}' not supported; choose from {POSE_CORES}")


class DeepVIO(nn.Module):
    def __init__(self, cfg: ModelConfig, solver: SolverConfig = SolverConfig(),
                 cde_solver: SolverConfig = SolverConfig(rtol=1e-4, atol=1e-6)):
        super().__init__()
        mt = cfg.model_type
        require_ported(mt)
        self.cfg = cfg
        self.solver = solver
        self.cde_solver = cde_solver
        self.Image_net = ImageEncoder(cfg)
        self.Inertial_net = InertialEncoder(cfg)
        if mt == "ode-rnn":
            self.Pose_net = PoseODERNN(cfg, solver)
        elif mt == "rnn":
            self.Pose_net = PoseRNN(cfg)
        elif mt in ("cde", "rde"):
            self.Pose_net = (PoseCDE if mt == "cde" else PoseRDE)(cfg, cde_solver)
        else:
            self.Pose_net = PoseNCP(cfg, cell_type=mt)

    @property
    def carry_lane_axis(self) -> int:
        return self.Pose_net.carry_lane_axis

    @property
    def cold_mask(self) -> bool:
        """Whether the pose core's fresh start is other than a zeroed carry
        (cde, rde: ``tanh(initial(obs0))``), so that a lane that starts
        beside carried ones needs the ``cold`` mask."""
        return getattr(self.Pose_net, "cold_mask", False)

    def forward(self, img: torch.Tensor, imu: torch.Tensor, ts: torch.Tensor,
                hc: Optional[Carry] = None,
                generator: Optional[torch.Generator] = None,
                cold: Optional[torch.Tensor] = None):
        """``generator``: the randomness of train-mode dropout and of hard
        fusion's Gumbel noise; ``cold`` (B,) bool: the lanes of a carried
        call that start afresh (:attr:`cold_mask` cores only)."""
        fv = self.Image_net(img, generator)
        return self.pose_from_visual(fv, imu, ts, hc, generator, cold)

    def encode(self, img: torch.Tensor, imu: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """The two encoders alone: (visual, inertial) features."""
        return self.Image_net(img, generator), self.Inertial_net(imu, generator)

    def pose_from_visual(self, fv: torch.Tensor, imu: torch.Tensor, ts: torch.Tensor,
                         hc: Optional[Carry] = None,
                         generator: Optional[torch.Generator] = None,
                         cold: Optional[torch.Tensor] = None):
        """The forward from visual features ``fv`` computed elsewhere (the
        frozen image encoder's inference graph in the ``frozen_encoder_eval``
        train step): the inertial encoder and the pose core."""
        return self.pose_from_features(fv, self.Inertial_net(imu, generator), ts, hc,
                                       generator, cold)

    def pose_from_features(self, fv: torch.Tensor, fi: torch.Tensor, ts: torch.Tensor,
                           hc: Optional[Carry] = None,
                           generator: Optional[torch.Generator] = None,
                           cold: Optional[torch.Tensor] = None):
        """The pose core alone, from visual and inertial features computed
        elsewhere (the serving engine's feature cache of its lanes)."""
        kw = {} if cold is None else {"cold": torch.as_tensor(cold, device=fi.device)}
        return self.Pose_net(fv, fi, ts, prev=hc, generator=generator, **kw)


def count_parameters(model: nn.Module) -> int:
    """The number of trainable weights: the parameters, not the BatchNorm
    running statistics (the JAX package counts its ``params`` tree)."""
    return sum(p.numel() for p in model.parameters())


def create_model(config: Config, *, seed: int = 0, device="cuda",
                 train: bool = False) -> DeepVIO:
    """Build DeepVIO on ``device`` with the reference's init drawn from a
    CPU ``torch.Generator`` seeded with ``seed``, in eval mode, or in train
    mode with ``train``."""
    device = resolve_device(device)
    model = DeepVIO(config.model, config.solver, config.cde_solver_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(train)


def analyse_flops(config: Config, batch_size: int = 1, *, device="cuda") -> dict:
    """The FLOPs of one inference forward of ``config``'s model (seed-0
    init) on zero inputs of ``batch_size`` windows, counted by
    ``utils/profiling.py::flops_analysis`` (JAX's ``analyse_flops``; what
    the count leaves out is said there)."""
    from ode_vio_tpu_torch.utils.profiling import flops_analysis

    device = resolve_device(device)
    model = create_model(config, seed=0, device=device)
    m = config.model
    S = m.seq_len
    img = torch.zeros(batch_size, S, m.img_h, m.img_w, 3, device=device)
    imu = torch.zeros(batch_size, 10 * (S - 1) + 1, 6, device=device)
    ts = (torch.arange(S, dtype=torch.float32, device=device) * 0.1).repeat(batch_size, 1)
    gen = torch.Generator(device).manual_seed(0) if m.fuse_method == "hard" else None

    def forward(img, imu, ts):
        with torch.inference_mode():
            return model(img, imu, ts, generator=gen)[0]

    return flops_analysis(forward, img, imu, ts)
