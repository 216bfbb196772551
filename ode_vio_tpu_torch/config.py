"""Typed configuration of the PyTorch port.

The port's copy of the solver and model dataclasses of the JAX package
(``ode_vio_tpu/config.py``): same field names, same defaults, so a
configuration reads the same in both packages. Only the fields that a
ported module reads are here; the others (the mesh) come with the
modules that read them.

One knob changes meaning: the JAX package's ``use_pallas`` tri-state
becomes :attr:`ModelConfig.use_kernels`, the switch for the port's
hand-written CUDA kernels. Its auto setting differs on purpose: the JAX
package leaves its fused ODE kernel off for ode-rnn by default, the port
turns its kernel on for every CUDA tensor, because that kernel is what
the port's inference path is built around. For cde and rde, the families
where the JAX package turns its fused CDE kernel on by default, the two
agree.

``ModelConfig.fast_dropout``, the JAX package's "fast mask bits on this
accelerator" switch for the conv trunk's train-mode dropout, selects the
port's hand-written dropout kernel K3 (``ops/cuda_kernels.py::
fused_dropout``, a seeded Philox mask regenerated in the backward pass);
False takes a plain Bernoulli dropout from the framework's generator, as
JAX falls back to ``nn.Dropout``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch


@dataclass(frozen=True)
class SolverConfig:
    """Adaptive solver operating point (ODE-RNN reference: dopri5, rtol
    1e-2, atol 1e-6, dt0 1e-4)."""

    # euler | heun | adaptive_heun | midpoint | bosh3 | fehlberg2 | rk4 |
    # tsit5 | dopri5 (the adaptive solve needs an error estimate), or the
    # fixed-grid Adams methods explicit_adams | implicit_adams, which
    # ignore rtol/atol and always take the fixed-step solve
    method: str = "dopri5"
    rtol: float = 1e-2
    atol: float = 1e-6
    dt0: float = 1e-4
    max_steps: int = 64          # inference step budget per interval
    # training's step budget per interval (the bounded, differentiable
    # solve, and both solves of the adjoint)
    max_steps_train: int = 16
    adaptive: bool = True        # False: `fixed_steps` equal steps per interval
    fixed_steps: int = 4
    # how training integrates: 'bounded' (masked steps recorded by
    # autograd), 'while' (the same in training) or 'adjoint' (the
    # continuous adjoint: a solve forward and a reverse solve of the
    # augmented state backward, no solver intermediates kept)
    unroll_mode: str = "bounded"
    safety: float = 0.9          # step controller safety factor
    factor_min: float = 0.2      # max step shrink per step
    factor_max: float = 10.0     # max step growth per step
    # the bounded solve checks for an early exit once per this many steps
    exit_chunk: int = 4


@dataclass(frozen=True)
class ModelConfig:
    """Model family and architecture hyperparameters."""

    model_type: str = "ode-rnn"  # ode-rnn | rnn | cde | rde | ltc | cfc
    img_w: int = 512
    img_h: int = 256
    v_f_len: int = 512           # visual feature length
    i_f_len: int = 256           # inertial feature length
    imu_dropout: float = 0.0
    seq_len: int = 11            # images per window
    fuse_method: str = "cat"     # cat | soft | hard
    # the conv trunk's train-mode dropout through kernel K3 (see above)
    fast_dropout: bool = True

    ode_hidden_dim: int = 512
    ode_fn_num_layers: int = 3
    ode_activation_fn: str = "tanh"  # tanh | relu | leaky_relu | softplus
    ode_rnn_type: str = "rnn"    # rnn | gru
    rnn_num_layers: int = 2
    rnn_hidden_dim: int = 1024   # the cfc/ltc cores' hidden state
    rnn_dropout_out: float = 0.0  # train-mode dropout on the RNN outputs

    # CDE core: field z -> hidden x cde_fn_num_layers -> hidden*(hidden+1)
    cde_hidden_dim: int = 128
    cde_fn_num_layers: int = 3
    cde_activation_fn: str = "tanh"
    # cde training through the continuous adjoint (cdeint_adjoint); the
    # rde core ignores it, as in JAX
    adjoint: bool = False
    cde_interpolation: str = "linear"   # linear | cubic (cubic-Hermite control path)
    # streaming eval: 'carry' continues from the last evaluated z;
    # 'history' re-integrates a ring buffer of the last `cde_history_cap`
    # observations from the first window's z0 (advanced over evicted
    # slots); 'reset' starts every window fresh
    cde_streaming_mode: str = "carry"
    cde_history_cap: int = 64

    # RDE core: depth-2 log-signature windows of a reduced path
    logsig_depth: int = 2
    logsig_window: int = 20
    rde_streaming_mode: str = "carry"  # carry | history | reset, as for cde
    rde_history_cap: int = 32          # in compressed-path knots
    rde_reduced_dim: int = 8

    # encoders run in `compute_dtype`, the solver state in float32
    compute_dtype: str = "bfloat16"
    # set by the BatchNorm-folding inference path (models/fold.py): the
    # encoders carry the folded shift in their conv bias and run no BN
    skip_bn: bool = False
    # the exact space-to-depth rewrite of the stride-2 convs with at most
    # 64 input channels (conv1, conv2), in train and eval; same parameters
    encoder_s2d: bool = False
    # eval-only int8 encoder: per-output-channel int8 weights, per-lane
    # dynamic int8 activations, exact int32 accumulation (models/encoders.py);
    # training always takes the float convs, parameters stay float
    encoder_int8: bool = False
    # The port's kernels (ops/cuda_kernels.py). None = auto: on for CUDA
    # tensors, off on the CPU. False takes the solver-core path
    # (ops/solvers/odeint.py), as use_pallas=False does in JAX.
    use_kernels: bool | None = None

    @property
    def f_len(self) -> int:
        return self.v_f_len + self.i_f_len

    def resolved_use_kernels(self, device: torch.device) -> bool:
        """An explicit flag wins; auto means "on for CUDA tensors"."""
        if self.use_kernels is not None:
            return self.use_kernels
        return torch.device(device).type == "cuda"


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths, windowing and irregularity injection (the
    reference's KITTI_dataset.py:20-138 and its augmentation flags)."""

    data_dir: str = "./dataset"
    train_seq: Sequence[str] = ("00", "01", "02", "04", "08", "09")
    val_seq: Sequence[str] = ("05", "07", "10")
    seq_len: int = 11
    imu_freq: int = 10           # IMU rows per image interval (IMU_FREQ)
    data_dropout: float = 0.0    # train-time random frame-drop probability
    data_dropout_std: float = 0.0
    eval_data_dropout: float = 0.0
    hflip: bool = False
    color: bool = False
    normalize: bool = False
    workers: int = 8
    shuffle: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """The optimisation schedule: Adam (or SGD with momentum 0.9) after a
    clip by global norm and weight decay added to the gradient, a
    three-phase step schedule of the learning rate over epochs."""

    optimizer: str = "adam"      # adam | sgd
    batch_size: int = 16
    grad_accumulation_steps: int = 1
    weight_decay: float = 5e-5
    epochs_warmup: int = 20
    epochs_joint: int = 40
    epochs_fine: int = 40
    lr_warmup: float = 1e-4
    lr_joint: float = 1e-5
    lr_fine: float = 1e-6
    # the pose regressor's own learning rate, in a group of its own that
    # the epoch schedule does not touch; None = one group
    lr_regressor: float | None = None
    gradient_clip: float = 5.0
    freeze_encoder: bool = False
    # with freeze_encoder: the frozen image encoder runs its inference
    # graph (BatchNorm folded from the current statistics, no dropout)
    frozen_encoder_eval: bool = False
    # carried-state exposure: with this probability a train step splits
    # its window at frame ``carry_split`` (0 = (seq_len-1)//2), trains the
    # first segment fresh and the second from the first's final hidden
    # state, the gradient cut at the splice (training/loop.py)
    carry_exposure: float = 0.0
    carry_split: int = 0
    # full-sequence TBPTT: windows in sequence order, the hidden state
    # carried across chains of this many train steps, the gradient cut at
    # every window boundary; 0 = off
    tbptt_chain: int = 0
    seed: int = 0
    angle_loss_weight: float = 100.0  # loss = 100*MSE(rot) + MSE(trans)
    print_frequency: int = 10    # cli.train logs every this many steps
    ckpt_every: int = 2          # cli.train checkpoints every N epochs

    def __post_init__(self):
        if not 0.0 <= self.carry_exposure <= 1.0:
            raise ValueError(f"carry_exposure={self.carry_exposure} must be a "
                             "probability in [0, 1]")
        if self.tbptt_chain and self.carry_exposure > 0.0:
            raise ValueError(
                "tbptt_chain and carry_exposure are mutually exclusive: "
                "full-sequence TBPTT trains the real carried-state "
                "distribution; the single-splice exposure is its "
                "within-window approximation")
        if self.tbptt_chain == 1:
            raise ValueError("tbptt_chain=1 never carries state (every step would be "
                             "a chain start); use 0 to disable or >= 2")

    @property
    def total_epochs(self) -> int:
        return self.epochs_warmup + self.epochs_joint + self.epochs_fine


@dataclass(frozen=True)
class Config:
    experiment_name: str = "experiment"
    save_dir: str = "./results"
    # a reference-layout checkpoint file, or a directory of the port's
    # checkpoints (training/checkpoint.py)
    pretrain: str | None = None
    pretrain_flownet: str | None = None  # torch FlowNet-S weights
    wandb: bool = False                  # cli.train logs to wandb where installed
    run_times: int = 1                   # eval repetitions (test_model.py:101)

    model: ModelConfig = field(default_factory=ModelConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    # the cde/rde solver: the reference's rtol 1e-4 with a wider eval
    # step budget than the ode-rnn's
    cde_solver_cfg: SolverConfig = field(
        default_factory=lambda: SolverConfig(rtol=1e-4, atol=1e-6, max_steps=256))
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    is an error, never a quiet switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return device


def flagship_config() -> Config:
    """The canonical ODE-VIO configuration: softplus ODE MLP with 2 hidden
    layers of 1024, 3 RNN layers, soft fusion, 256x512 images, seq_len 11,
    trained with the image encoder frozen, with frame dropout 0.3 in
    training and in evaluation."""
    return Config(
        model=ModelConfig(
            model_type="ode-rnn",
            ode_activation_fn="softplus",
            ode_fn_num_layers=2,
            ode_hidden_dim=1024,
            rnn_num_layers=3,
            fuse_method="soft",
        ),
        train=TrainConfig(freeze_encoder=True),
        data=DataConfig(data_dropout=0.3, data_dropout_std=0.1,
                        eval_data_dropout=0.3),
    )
