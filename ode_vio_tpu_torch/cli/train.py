"""Training entry point: ``python -m ode_vio_tpu_torch.cli.train --data_dir ...``

The port's counterpart of ``ode_vio_tpu/cli/train.py`` (the reference's
``scripts/train_model.py:163-249``): a fresh loader every epoch with its
frame-dropout ratio resampled, the three-phase learning rate, a checkpoint
every ``--ckpt_every`` epochs, a streaming KITTI evaluation after every
epoch with the best t_rel checkpointed, and optional wandb logging. Trains
all six pose cores on one device, ``--device`` (default ``cuda``).
``--carry_exposure`` makes that share of the steps carried (the window
split, its second segment seeded with the first's detached hidden state);
``--tbptt_chain N`` trains on windows in sequence order with the hidden
state carried across chains of N steps. ``--profile_dir`` writes a
``torch.profiler`` trace of the first epoch's steps 1-4 there.

Data parallelism (``parallel/mesh.py``): ``--mesh_data`` ranks (-1: as
many as divide the batch and the cards) each train on their block of every
global batch, ``--mesh_model`` ranks on the same block, as the JAX
command line resolves its mesh. Without a process group, more than one
rank starts one process per card (rank r on ``cuda:r``; on the CPU they
share it) and this process waits for them; in a process group (one of
those, or a rank of a ``--multihost`` job) the mesh spans its ranks. The
ranks decode only their rows, share BatchNorm statistics and average
their gradients, so every rank holds the same state; rank 0 logs to the
console, evaluates, plots and calls wandb, and every rank takes part in
writing checkpoints (rank 0 writes). ``--eval_dp`` is ignored here, as
the JAX command line ignores it.

``--pretrain`` takes a reference-layout checkpoint file, which
warm-starts the weights with a fresh optimizer, or a checkpoints directory
of this command line, from whose latest epoch the run resumes with the
optimizer, step and generator it saved. Every random draw comes from the
seed and the epoch or from the checkpointed train state, so a run resumed
at an epoch boundary repeats the run that did not stop.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch.distributed as dist

from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args, run_device
from ode_vio_tpu_torch.cli.test import write_plots
from ode_vio_tpu_torch.config import Config
from ode_vio_tpu_torch.data.evaluation import KittiEvaluator
from ode_vio_tpu_torch.data.kitti import (BoundarySafeBatchSampler, KittiDataset,
                                          StreamingChainSampler)
from ode_vio_tpu_torch.data.loader import PrefetchingLoader
from ode_vio_tpu_torch.data.transforms import get_transforms
from ode_vio_tpu_torch.models.convert import load_flownet, load_pretrain, require_port_checkpoint
from ode_vio_tpu_torch.models.deepvio import count_parameters, create_model
from ode_vio_tpu_torch.parallel.mesh import (auto_data_axis, batch_rows, create_mesh, is_rank0,
                                             launch, local_devices, world_size)
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
from ode_vio_tpu_torch.training.loop import (
    create_train_state,
    lr_for_epoch,
    make_infer_fn,
    make_streaming_train_step,
    make_train_step,
    set_learning_rate,
)
from ode_vio_tpu_torch.utils.logging_utils import setup_experiment_directories, setup_logger
from ode_vio_tpu_torch.utils.profiling import trace


def get_train_loader(cfg: Config, epoch: int, logger,
                     rows: Optional[slice] = None) -> PrefetchingLoader:
    """A fresh dataset for ``epoch`` with a frame-dropout ratio drawn from
    N(data_dropout, data_dropout_std) clipped to [0, 0.9], batched without
    crossing a sequence boundary and decoded by the native pipeline. Under
    ``tbptt_chain`` the batches are ``StreamingChainSampler``'s: lane b of
    consecutive batches walks one chunk of boundary-sharing windows.
    ``rows``: the rows of each global batch this rank decodes; the draws
    are the whole batch's on every rank."""
    rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
    ratio = float(np.clip(rng.normal(cfg.data.data_dropout, cfg.data.data_dropout_std), 0, 0.9))
    logger.info("epoch %d dropout ratio: %.4f", epoch, ratio)
    # decode happens natively at the target size; the transforms are the
    # augmentations only
    aug = get_transforms((cfg.model.img_h, cfg.model.img_w), hflip=cfg.data.hflip,
                         color=cfg.data.color, normalize=cfg.data.normalize, rng=rng,
                         base=False)
    ds = KittiDataset(cfg.data.data_dir, cfg.data.seq_len, cfg.data.train_seq,
                      transform=None, dropout=ratio, rng=rng)
    if cfg.train.tbptt_chain:
        sampler = StreamingChainSampler(ds.seq_num_windows, cfg.train.batch_size,
                                        cfg.train.tbptt_chain, stride=cfg.data.seq_len - 1,
                                        shuffle=cfg.data.shuffle, seed=cfg.train.seed + epoch)
    else:
        sampler = BoundarySafeBatchSampler(len(ds), cfg.train.batch_size,
                                           shuffle=cfg.data.shuffle,
                                           seed=cfg.train.seed + epoch, drop_last=True)
    return PrefetchingLoader(ds, sampler, (cfg.model.img_h, cfg.model.img_w), transform=aug,
                             decode_threads=max(1, cfg.data.workers), rows=rows)


def train_epoch(cfg: Config, loader, train_step, state, logger, epoch: int, steps=None,
                profile_dir=None):
    """One pass over ``loader``; returns the state and the mean loss.
    ``steps``, a list, receives each step's wall seconds (the step waited
    for), loss and truncated solves. Under ``tbptt_chain`` the hidden state
    threads from step to step and resets at every chain start (each
    ``chain``-th step), where the sampler starts its chains. With
    ``profile_dir``, epoch 0's steps 1-4 (after the first, which builds
    the kernels and is the profiler's warm-up) are traced into it
    (utils/profiling.py::trace), the trace closed once step 4's loss is
    ready, or at the end of a shorter epoch."""
    losses = []
    chain = cfg.train.tbptt_chain
    hc = None
    traced = bool(profile_dir) and epoch == 0
    profiling = contextlib.ExitStack()
    with profiling:  # closes the trace of a short epoch, or of one that failed
        for it, batch in enumerate(loader):
            if traced and it == 0:
                prof = profiling.enter_context(trace(profile_dir, warmup_steps=1))
            t = time.perf_counter()
            if chain:
                if it % chain == 0:
                    hc = None
                state, metrics, hc = train_step(state, *batch, hc)
            else:
                state, metrics = train_step(state, *batch)
            losses.append(metrics["loss"])
            if steps is not None:
                loss = float(metrics["loss"])  # waits for the step
                steps.append({"s": time.perf_counter() - t, "loss": loss,
                              "solver_incomplete": int(metrics["solver_incomplete"])})
            if traced and it < 4:
                prof.step()  # the trace begins with step 1, each step marked
            if traced and it == 4:
                float(metrics["loss"])  # the traced steps end on the device too
                profiling.close()
                logger.info("profiler trace written to %s", profile_dir)
            if (it + 1) % cfg.train.print_frequency == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logger.info("epoch %d iter %d/%d loss %.6f angle %.6f trans %.6f", epoch,
                            it + 1, len(loader), m["loss"], m["angle_loss"], m["trans_loss"])
                if m["solver_incomplete"] > 0:
                    logger.warning(
                        "epoch %d iter %d: %d ODE solves hit the step budget before t1 "
                        "(truncated integral; raise max_steps_train or loosen tolerances)",
                        epoch, it + 1, int(m["solver_incomplete"]))
    return state, float(np.mean([float(x) for x in losses])) if losses else 0.0


def _exposure_step(fresh_step, carried_step, cfg: Config, epoch: int):
    """The step of ``epoch`` under ``carry_exposure``: each call takes the
    carried step with that probability, else the fresh one. The draws come
    from (seed, epoch), so a run resumed at an epoch boundary makes the
    draws of the run that did not stop."""
    rng = np.random.default_rng(cfg.train.seed * 100003 + epoch + 0xCA44)

    def step(state, *batch):
        if rng.random() < cfg.train.carry_exposure:
            return carried_step(state, *batch)
        return fresh_step(state, *batch)

    return step


def _warm_start_epoch(pretrain) -> int:
    """The epoch a warm start from a reference-layout checkpoint file goes
    on from: the reference names its epoch checkpoints ``001.pth``..., and
    parses exactly three trailing digits (train_model.py:175-177); any
    other name (the published ``ode-vio-v1.pth``, whose 1 is a version)
    starts at epoch 0."""
    m = re.search(r"(?<![0-9])(\d{3})\.(?:pth|tar|pt|npz)$", str(pretrain))
    return int(m.group(1)) + 1 if m else 0


def start_wandb(args, cfg: Config, logger):
    """A wandb run, or None with a warning where wandb is not installed or
    cannot start (training goes on without it)."""
    try:
        import wandb

        # an explicit id resumes that run (train_model.py:237-248)
        run_id = args.wandb_id
        resume = "must" if run_id else "allow"
        if run_id is None:
            run_id = wandb.util.generate_id()
        logger.info("wandb run id: %s", run_id)
        return wandb.init(project="ode-vio-tpu", group=args.wandb_group, id=run_id,
                          resume=resume, name=cfg.experiment_name, config=vars(args))
    except Exception as e:  # not installed, or offline
        logger.warning("wandb unavailable (%s); continuing without", e)
        return None


def rank_devices(cfg: Config, device) -> list:
    """The devices of the run's ranks, as the JAX command line sizes its
    mesh: ``mesh_data`` (-1: :func:`auto_data_axis` over this host's cards)
    times ``mesh_model`` of them; on the CPU the ranks share it. SystemExit
    for more cards than there are, or a model axis that leaves no data
    axis."""
    d, m = cfg.mesh.data_axis, cfg.mesh.model_axis
    if device.type == "cuda":
        cards = local_devices(-1, device)
    else:
        cards = local_devices(m if d == -1 else d * m, device)
    if m < 1 or len(cards) // m < 1:
        raise SystemExit(f"--mesh_model {m} does not fit {len(cards)} devices")
    if d == -1:
        d = auto_data_axis(cfg.train.batch_size, m, cards)
    if d * m > len(cards):
        raise SystemExit(f"--mesh_data {d} x --mesh_model {m} needs {d * m} devices and "
                         f"there are {len(cards)}")
    return cards[:d * m]


def _rank(device, argv: list, timed: bool) -> Optional[dict]:
    """One rank of a run that :func:`main` started: the run on ``device``."""
    timing = {} if timed else None
    main([*argv, "--device", str(device)], timing)
    return timing


def main(argv=None, timing: dict | None = None) -> None:
    """``timing``, a dict, receives under ``epochs`` one record per epoch:
    its steps (see :func:`train_epoch`), train and eval seconds, the
    evaluator's timing, t_rel and r_rel. A run that starts its ranks puts
    rank 0's records there and every rank's timing under ``ranks``."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = run_device(args)
    if not dist.is_initialized():
        devices = rank_devices(cfg, device)
        if len(devices) > 1:
            argv = list(sys.argv[1:] if argv is None else argv)
            ranks = launch(_rank, devices, argv, timing is not None)
            if timing is not None:
                timing.update(ranks[0], ranks=ranks)
            return
    _train(args, cfg, device, timing)


def _train(args, cfg: Config, device, timing: dict | None) -> None:
    """The run of :func:`main` in this process: alone, or as one rank of
    the process group's mesh."""
    rank0 = is_rank0()
    data = cfg.mesh.data_axis
    if data == -1:
        data = auto_data_axis(cfg.train.batch_size, cfg.mesh.model_axis, range(world_size()))
    try:
        mesh = create_mesh(data, cfg.mesh.model_axis)
    except ValueError as e:
        raise SystemExit(f"--mesh_data/--mesh_model: {e}") from None
    rows = batch_rows(mesh, cfg.train.batch_size)
    dirs = setup_experiment_directories(cfg.save_dir, cfg.experiment_name)
    suffix = "" if rank0 else f"_rank{dist.get_rank()}"
    logger = setup_logger(f"train_{cfg.experiment_name}{suffix}", dirs["logs"], console=rank0)
    logger.info("config: %s", cfg)
    logger.info("device: %s", device)
    logger.info("mesh: %s (of %d ranks), rows %d:%d of each batch", mesh.shape, world_size(),
                rows.start, rows.stop)

    model = create_model(cfg, seed=cfg.train.seed, device=device, train=True)
    logger.info("total parameters: %d", count_parameters(model))
    if cfg.pretrain_flownet:
        load_flownet(model, cfg.pretrain_flownet)
        logger.info("pretrained FlowNet-S loaded from %s", cfg.pretrain_flownet)

    init_epoch, best = 0, float("inf")
    warm = cfg.pretrain is not None and Path(cfg.pretrain).is_file()
    if warm:
        # a reference-layout file warm-starts the weights only (upstream
        # --pretrain; upstream never checkpoints Adam's moments)
        load_pretrain(model, cfg.pretrain)
        init_epoch = _warm_start_epoch(cfg.pretrain)
        logger.info("warm-started from reference checkpoint %s (epoch %d)", cfg.pretrain,
                    init_epoch)
    state = create_train_state(cfg, model, seed=cfg.train.seed + 1, device=device, mesh=mesh)
    ckpt = CheckpointManager(dirs["checkpoints"])
    if cfg.pretrain and not warm:
        resume = CheckpointManager(cfg.pretrain)
        latest = resume.latest_epoch()
        if latest is not None:
            name = resume.epoch_name(latest)
            require_port_checkpoint(resume, name)
            state = resume.restore(name, state)
            init_epoch = latest + 1
            # the best so far crosses the resume, so a resumed run cannot
            # overwrite a better earlier best checkpoint
            best = float((resume.metadata(name) or {}).get("best_t_rel", best))
            logger.info("resumed from %s epoch %d (best t_rel %.4f)", cfg.pretrain, latest, best)

    if cfg.train.tbptt_chain:
        train_step = make_streaming_train_step(cfg, device=device, mesh=mesh)
        if cfg.data.hflip or cfg.data.color:
            logger.warning(
                "tbptt_chain=%d with per-window random augmentations (--hflip/--color): "
                "augmentation draws are independent per window, so a chain's carried "
                "state crosses inconsistently-augmented windows", cfg.train.tbptt_chain)
    else:
        train_step = make_train_step(cfg, device=device, mesh=mesh)
    carried_step = None
    if cfg.train.carry_exposure > 0.0:
        carried_step = make_train_step(cfg, carry=True, device=device, mesh=mesh)
        mt = cfg.model.model_type
        mode = getattr(cfg.model, f"{mt}_streaming_mode", None)
        if mt in ("cde", "rde") and mode != "carry":
            logger.warning(
                "carry_exposure=%.2f targets 'carry'-mode streaming eval (the carried "
                "regime seeds segment 2 with the previous segment's final latent, exactly "
                "what --%s_streaming_mode=carry feeds the core at eval); with streaming "
                "mode %r the exposed distribution does not match eval's",
                cfg.train.carry_exposure, mt, mode)
    # one inference callable for the whole run, its weights swapped each
    # epoch, with the BatchNorm statistics folded into the convolutions;
    # rank 0 evaluates, as the JAX command line evaluates once
    infer = make_infer_fn(state.model, fold_bn=True, device=device) if rank0 else None
    wandb_run = start_wandb(args, cfg, logger) if cfg.wandb and rank0 else None
    records = None if timing is None else timing.setdefault("epochs", [])

    for epoch in range(init_epoch, cfg.train.total_epochs):
        lr = lr_for_epoch(cfg, epoch)
        set_learning_rate(state.optimizer, lr)
        logger.info("epoch %d lr %g", epoch, lr)

        loader = get_train_loader(cfg, epoch, logger, rows)
        steps = None if records is None else []
        t0 = time.perf_counter()
        step = train_step if carried_step is None else _exposure_step(
            train_step, carried_step, cfg, epoch)
        state, avg_loss = train_epoch(cfg, loader, step, state, logger, epoch, steps,
                                      args.profile_dir)
        train_s = time.perf_counter() - t0
        logger.info("epoch %d done: loss %.6f (%.1fs)", epoch, avg_loss, train_s)

        if epoch % cfg.train.ckpt_every == 0:
            ckpt.save(ckpt.epoch_name(epoch), state, {"epoch": epoch, "best_t_rel": best})

        evaluator, result, eval_s = None, [None, None], None
        if rank0:
            evaluator = KittiEvaluator(
                cfg.data.data_dir, cfg.data.val_seq, cfg.data.seq_len,
                (cfg.model.img_h, cfg.model.img_w), cfg.data.eval_data_dropout,
                rng=np.random.default_rng(cfg.train.seed + 7919 + epoch))
            infer.set_variables(state.model.state_dict())
            t0 = time.perf_counter()
            errors = evaluator.eval(infer)
            eval_s = time.perf_counter() - t0
            result = [float(np.mean([e[k] for e in errors])) for k in ("t_rel", "r_rel")]
        if world_size() > 1:  # the other ranks wait for rank 0's evaluation
            dist.broadcast_object_list(result, src=0)
        t_rel, r_rel = result
        logger.info("epoch %d eval: t_rel %.4f r_rel %.4f", epoch, t_rel, r_rel)
        if rank0:
            if infer.incomplete() > 0:
                logger.warning("epoch %d eval: %d ODE solves hit the step budget before t1 "
                               "(truncated; raise ode_max_steps)", epoch, infer.incomplete())
            write_plots(evaluator, dirs["graphs"], logger, tag=f"_{epoch}")
        if t_rel < best:
            best = t_rel
            ckpt.save(f"best_{best:.2f}", state, {"epoch": epoch, "t_rel": best})
        if wandb_run is not None:
            wandb_run.log({"t_rel": t_rel, "r_rel": r_rel, "best_t_rel": best,
                           "avg_pose_loss": avg_loss})
        if records is not None:
            records.append({"epoch": epoch, "lr": lr, "loss": avg_loss, "steps": steps,
                            "train_s": train_s, "eval_s": eval_s,
                            "eval_timing": None if evaluator is None else dict(evaluator.timing),
                            "t_rel": t_rel, "r_rel": r_rel,
                            "eval_incomplete": None if infer is None else infer.incomplete()})

    logger.info("training finished, best t_rel %.4f", best)


if __name__ == "__main__":
    main()
