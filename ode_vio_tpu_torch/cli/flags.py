"""One shared command-line flag set building the port's typed Config.

The port's copy of ``ode_vio_tpu/cli/flags.py``: the same flags under the
same names and defaults, so a command line reads the same in both
packages, and ``cli/test.py``, ``cli/serve.py``, ``cli/train.py``,
``cli/export.py`` and ``cli/parity.py`` consume one parser. Two flags differ: ``--device`` (default
``cuda``; the port's entry points run on the card unless asked for the
CPU) and ``--use_kernels`` / ``--no-use_kernels`` in place of
``--use_pallas``.

A flag whose feature the port does not have yet raises ``SystemExit``
when it is set, naming the ``ROADMAP.md`` item that brings it
(:data:`UNPORTED`); it is never silently ignored.
"""

from __future__ import annotations

import argparse

import torch

from ode_vio_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    SolverConfig,
    TrainConfig,
)

# flag -> (its value when not set, the ROADMAP.md item that ports it)
UNPORTED = {
    "multihost": (False, "Queue 1 item 7 (parallel/mesh.py)"),
    "mesh_model": (1, "Queue 1 item 7 (parallel/mesh.py)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    # paths / experiment
    p.add_argument("--data_dir", type=str, default="./dataset")
    p.add_argument("--save_dir", type=str, default="./results")
    p.add_argument("--experiment_name", type=str, default="experiment")
    p.add_argument("--pretrain", type=str, default=None,
                   help="reference-layout checkpoint file (.pth/.tar/.pt, or "
                        "the .npz of ode_vio_tpu.cli.export), or a checkpoints "
                        "directory written by the port's cli.train (its "
                        "latest epoch; cli.train resumes from it)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cpu' runs the kernels' "
                        "plain versions")
    p.add_argument("--pretrain_flownet", type=str, default=None,
                   help="torch FlowNet-S .pth(.tar) to convert and load")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_group", type=str, default=None,
                   help="wandb run group (train_model.py:240)")
    p.add_argument("--wandb_id", type=str, default=None,
                   help="wandb run id to resume (resume='must', "
                        "train_model.py:238)")
    p.add_argument("--run_times", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--print_frequency", type=int, default=10)
    p.add_argument("--ckpt_every", type=int, default=2,
                   help="save a checkpoint every N epochs "
                        "(train_model.py:223)")

    # sequences
    p.add_argument("--train_seq", type=str, nargs="+",
                   default=["00", "01", "02", "04", "08", "09"])
    p.add_argument("--val_seq", type=str, nargs="+", default=["05", "07", "10"])

    # model
    p.add_argument("--model_type", type=str, default="ode-rnn",
                   choices=["ode-rnn", "rnn", "cde", "rde", "cfc", "ltc"])
    p.add_argument("--img_w", type=int, default=512)
    p.add_argument("--img_h", type=int, default=256)
    p.add_argument("--v_f_len", type=int, default=512)
    p.add_argument("--i_f_len", type=int, default=256)
    p.add_argument("--imu_dropout", type=float, default=0.0)
    p.add_argument("--seq_len", type=int, default=11)
    p.add_argument("--fuse_method", type=str, default="cat",
                   choices=["cat", "soft", "hard"])
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--encoder_int8", action="store_true",
                   help="quantised int8 encoder inference (eval-only; "
                        "exact int32 sums, float checkpoints unchanged)")
    p.add_argument("--no_fold_bn", action="store_true",
                   help="disable inference-time BatchNorm folding "
                        "(models/fold.py; folding is exact at eval)")
    p.add_argument("--batch_runs", action="store_true",
                   help="fan every (--run_times repeat, sequence) pair out "
                        "as one batch lane of a single streaming eval "
                        "instead of looping the repeats sequentially "
                        "(the reference's test_model.py:101-128 loop)")
    p.add_argument("--eval_dp", type=int, default=1,
                   help="shard the eval batch lanes (cli.test) or serving "
                        "session lanes (cli.serve multi-session) over this "
                        "many devices (-1 = all local devices); only 1 is "
                        "ported")
    p.add_argument("--exact_dropout", action="store_true",
                   help="train-mode trunk dropout from the framework's "
                        "Bernoulli sampler instead of the Philox kernel K3 "
                        "(same semantics, other bits)")
    p.add_argument("--use_kernels", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the port's hand-written CUDA kernels (K1 for the "
                        "ode-rnn solve, K2 for cde/rde) on the inference "
                        "path (default auto: on for cuda, off on the cpu; "
                        "--no-use_kernels takes the PyTorch solver core)")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first module "
                        "whose output holds a NaN, and detect anomalies in "
                        "the backward (as jax_debug_nans, NaN only)")

    # ODE core
    p.add_argument("--ode_hidden_dim", type=int, default=512)
    p.add_argument("--ode_fn_num_layers", type=int, default=3)
    p.add_argument("--ode_activation_fn", type=str, default="tanh")
    p.add_argument("--ode_solver", type=str, default="dopri5")
    p.add_argument("--ode_rtol", type=float, default=1e-2)
    p.add_argument("--ode_atol", type=float, default=1e-6)
    p.add_argument("--ode_max_steps", type=int, default=64)
    p.add_argument("--ode_max_steps_train", type=int, default=16,
                   help="differentiable (bounded-scan) step budget per "
                        "solve segment during training; the chunked "
                        "early exit means unused budget costs only its "
                        "residual zero-fill, and exhausting it is "
                        "surfaced via the solver_incomplete metric")
    p.add_argument("--ode_exit_chunk", type=int, default=4,
                   help="early-exit chunk of the batched training solve: "
                        "skip whole chunks of the masked scan once every "
                        "lane converged (0 = one chunk spanning the whole "
                        "budget)")
    p.add_argument("--ode_fixed_step", action="store_true",
                   help="fixed-step integration (update_method parity)")

    # RNN core
    p.add_argument("--ode_rnn_type", type=str, default="rnn",
                   choices=["rnn", "gru"])
    p.add_argument("--rnn_num_layers", type=int, default=2)
    p.add_argument("--rnn_hidden_dim", type=int, default=1024)
    p.add_argument("--rnn_dropout_out", type=float, default=0.0)

    # CDE / RDE core
    p.add_argument("--cde_hidden_dim", type=int, default=128)
    p.add_argument("--cde_fn_num_layers", type=int, default=3)
    p.add_argument("--cde_num_layers", type=int, default=3)
    p.add_argument("--cde_activation_fn", type=str, default="tanh")
    p.add_argument("--cde_solver", type=str, default="dopri5")
    p.add_argument("--cde_max_steps", type=int, default=256,
                   help="EVAL step budget per CDE/RDE segment. At the "
                        "reference's rtol 1e-4 a stiff path can need far "
                        "more than the ODE-RNN budget; eval solves pay "
                        "only for steps actually taken, and hitting the "
                        "cap is counted as an incomplete solve. Training "
                        "uses --ode_max_steps_train.")
    p.add_argument("--cde_interpolation", type=str, default="linear",
                   choices=["linear", "cubic"])
    p.add_argument("--cde_streaming_mode", type=str, default="carry",
                   choices=["carry", "history", "reset"],
                   help="eval statefulness: carry last z (default), the "
                        "reference's re-integrated history ring buffer, or "
                        "reset (stateless windows, the training regime)")
    p.add_argument("--cde_history_cap", type=int, default=64)
    p.add_argument("--rde_streaming_mode", type=str, default="carry",
                   choices=["carry", "history", "reset"],
                   help="RDE eval statefulness (mirrors "
                        "--cde_streaming_mode; history = accumulated "
                        "log-signature path, PoseRDE.py:90-95)")
    p.add_argument("--rde_history_cap", type=int, default=32)
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--rde_reduced_dim", type=int, default=8)

    # training
    p.add_argument("--optimizer", type=str, default="Adam")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--frozen_encoder_eval", action="store_true",
                   help="with --freeze_encoder: run the frozen image "
                        "encoder in inference mode inside the train step "
                        "(BN folded into conv bias, trunk dropout off). "
                        "Default off = exact reference torch-train-mode "
                        "semantics (train_model.py:191-194)")
    p.add_argument("--carry_exposure", type=float, default=0.0,
                   help="probability a train step uses the carried "
                        "(TBPTT-split) window: segment 1 trains fresh, its "
                        "detached final hidden state seeds segment 2; in "
                        "[0, 1], 0 = off")
    p.add_argument("--carry_split", type=int, default=0,
                   help="boundary frame index k of the carried split: "
                        "1..seq_len-2 for ode-rnn/rnn/cfc/ltc, 2..seq_len-3 "
                        "for cde/rde; 0 = midpoint")
    p.add_argument("--tbptt_chain", type=int, default=0,
                   help="full-sequence TBPTT: windows in sequence order, "
                        "the hidden state carried across N consecutive "
                        "train steps, then reset (gradients cut at window "
                        "boundaries); exclusive with --carry_exposure; "
                        "0 = off")
    p.add_argument("--weight_decay", type=float, default=5e-5)
    p.add_argument("--epochs_warmup", type=int, default=20)
    p.add_argument("--epochs_joint", type=int, default=40)
    p.add_argument("--epochs_fine", type=int, default=40)
    p.add_argument("--lr_warmup", type=float, default=1e-4)
    p.add_argument("--lr_joint", type=float, default=1e-5)
    p.add_argument("--lr_fine", type=float, default=1e-6)
    p.add_argument("--lr_regressor", type=float, default=None,
                   help="separate fixed LR for the pose-regressor param "
                        "group (reference utils/utils.py:116-119)")
    p.add_argument("--gradient_clip", type=float, default=5.0)
    p.add_argument("--shuffle", type=lambda s: s.lower() != "false", default=True)

    # irregularity / augmentation
    p.add_argument("--data_dropout", type=float, default=0.0)
    p.add_argument("--data_dropout_std", type=float, default=0.0)
    p.add_argument("--eval_data_dropout", type=float, default=0.0)
    p.add_argument("--hflip", action="store_true")
    p.add_argument("--color", action="store_true")
    p.add_argument("--normalize", action="store_true")

    # mesh / distributed
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data-parallel axis size (-1 = all devices)")
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--multihost", action="store_true",
                   help="multi-host runs (not ported)")

    # profiling
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace (Chrome/Perfetto "
                        "JSON) of training steps 1-4 of the first epoch "
                        "into this directory")
    return p


def refuse_unported(args) -> None:
    """``SystemExit`` for the first set flag whose feature is not ported."""
    for name, (unset, item) in UNPORTED.items():
        if getattr(args, name) != unset:
            raise SystemExit(f"--{name} is not ported to ode_vio_tpu_torch "
                             f"yet (ROADMAP.md, {item})")
    if args.mesh_data not in (-1, 1):
        raise SystemExit("--mesh_data other than 1 is not ported to "
                         "ode_vio_tpu_torch yet (ROADMAP.md, Queue 1 item 7 "
                         "(parallel/mesh.py))")


def check_eval_dp(eval_dp: int, device: torch.device) -> None:
    """``--eval_dp``: -1 means every card there is (1 on the CPU). One
    device is all the port runs on until ``parallel/mesh.py`` is ported."""
    if eval_dp == -1:
        eval_dp = torch.cuda.device_count() if device.type == "cuda" else 1
    if eval_dp > 1:
        raise SystemExit(f"--eval_dp {eval_dp}: sharding eval or serving "
                         "lanes over several devices is not ported to "
                         "ode_vio_tpu_torch yet (ROADMAP.md, Queue 1 item 7 "
                         "(parallel/mesh.py))")


def config_from_args(args) -> Config:
    """The typed Config of the flags; ``--debug_nans`` turns the NaN trap
    on for the whole process (``utils/profiling.py::set_debug_nans``), as
    the JAX package sets ``jax_debug_nans``."""
    refuse_unported(args)
    if args.debug_nans:
        from ode_vio_tpu_torch.utils.profiling import set_debug_nans

        set_debug_nans(True)
    return Config(
        experiment_name=args.experiment_name,
        save_dir=args.save_dir,
        pretrain=args.pretrain,
        pretrain_flownet=args.pretrain_flownet,
        wandb=args.wandb,
        run_times=args.run_times,
        model=ModelConfig(
            model_type=args.model_type,
            img_w=args.img_w, img_h=args.img_h,
            v_f_len=args.v_f_len, i_f_len=args.i_f_len,
            imu_dropout=args.imu_dropout, seq_len=args.seq_len,
            fuse_method=args.fuse_method,
            ode_hidden_dim=args.ode_hidden_dim,
            ode_fn_num_layers=args.ode_fn_num_layers,
            ode_activation_fn=args.ode_activation_fn,
            ode_rnn_type=args.ode_rnn_type,
            rnn_num_layers=args.rnn_num_layers,
            rnn_hidden_dim=args.rnn_hidden_dim,
            rnn_dropout_out=args.rnn_dropout_out,
            cde_hidden_dim=args.cde_hidden_dim,
            cde_fn_num_layers=args.cde_fn_num_layers,
            cde_activation_fn=args.cde_activation_fn,
            adjoint=args.adjoint,
            cde_interpolation=args.cde_interpolation,
            cde_streaming_mode=args.cde_streaming_mode,
            cde_history_cap=args.cde_history_cap,
            rde_streaming_mode=args.rde_streaming_mode,
            rde_history_cap=args.rde_history_cap,
            rde_reduced_dim=args.rde_reduced_dim,
            compute_dtype=args.compute_dtype,
            encoder_int8=args.encoder_int8,
            use_kernels=args.use_kernels,
            fast_dropout=not args.exact_dropout,
        ),
        solver=SolverConfig(
            method=args.ode_solver, rtol=args.ode_rtol, atol=args.ode_atol,
            max_steps=args.ode_max_steps,
            max_steps_train=args.ode_max_steps_train,
            adaptive=not args.ode_fixed_step,
            unroll_mode="adjoint" if args.adjoint else "bounded",
            exit_chunk=args.ode_exit_chunk,
        ),
        cde_solver_cfg=SolverConfig(
            method=args.cde_solver, rtol=1e-4, atol=1e-6,
            max_steps=args.cde_max_steps,
            max_steps_train=args.ode_max_steps_train,
        ),
        data=DataConfig(
            data_dir=args.data_dir,
            train_seq=tuple(args.train_seq), val_seq=tuple(args.val_seq),
            seq_len=args.seq_len,
            data_dropout=args.data_dropout,
            data_dropout_std=args.data_dropout_std,
            eval_data_dropout=args.eval_data_dropout,
            hflip=args.hflip, color=args.color, normalize=args.normalize,
            workers=args.workers, shuffle=args.shuffle,
        ),
        train=TrainConfig(
            optimizer=args.optimizer.lower(),
            batch_size=args.batch_size,
            grad_accumulation_steps=args.grad_accumulation_steps,
            weight_decay=args.weight_decay,
            epochs_warmup=args.epochs_warmup,
            epochs_joint=args.epochs_joint,
            epochs_fine=args.epochs_fine,
            lr_warmup=args.lr_warmup, lr_joint=args.lr_joint,
            lr_fine=args.lr_fine, lr_regressor=args.lr_regressor,
            gradient_clip=args.gradient_clip,
            freeze_encoder=args.freeze_encoder,
            frozen_encoder_eval=args.frozen_encoder_eval,
            carry_exposure=args.carry_exposure,
            carry_split=args.carry_split,
            tbptt_chain=args.tbptt_chain,
            seed=args.seed,
            print_frequency=args.print_frequency,
            ckpt_every=args.ckpt_every,
        ),
    )


def build_model(cfg: Config, device: torch.device, logger, verb: str):
    """The flags' DeepVIO on ``device``: the seeded init, with the
    ``--pretrain`` checkpoint file or port checkpoints directory loaded
    into it where one is given."""
    from ode_vio_tpu_torch.models.convert import load_pretrain
    from ode_vio_tpu_torch.models.deepvio import create_model

    model = create_model(cfg, seed=cfg.train.seed, device=device)
    if cfg.pretrain:
        logger.info("loaded checkpoint %s", load_pretrain(model, cfg.pretrain))
    else:
        logger.warning("no --pretrain given: %s random init", verb)
    return model
