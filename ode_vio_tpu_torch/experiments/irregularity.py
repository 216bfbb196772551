"""Irregular-sampling robustness on the port: the JAX repository's
headline experiment (``scripts/exp_irregularity.py``), flag for flag, on
the hermetic odometric fixture.

The continuous-time flagship (ode-rnn) against the discrete baseline
(rnn), and the CfC liquid cell, with matched dimensions, data, budget and
seeds:

  * data: a synthetic mini-KITTI tree with odometry-consistent IMU
    (``data/synthetic.py::make_imu_odometric``): each frame interval's IMU
    rows carry that interval's body-frame velocity, so after frame
    dropout the displacement scales with the irregular elapsed time and
    recovering the pose needs the timestamps. The ode-rnn core integrates
    its latent over the true dt; the discrete RNN ignores ts;
  * train: every family alike, 128x64 images, 64-d features, frame
    dropout N(0.3, 0.1) drawn again each epoch, batches of 8 on sequences
    00 and 01;
  * eval: the KITTI segment metric and windowed RMSE on sequence 05 at
    eval frame dropout 0 / 0.3 / 0.5 / 0.7, ``--run_times`` repeats with
    dropout drawn anew each time.

Run from the repository's root (on the card; ``--device cpu`` runs it on
the CPU)::

    python -m ode_vio_tpu_torch.experiments.irregularity --families ode-rnn cfc rnn

It prints one JSON line per (family, eval mode, eval dropout), each
family's training seconds, and the summary table. ``--carry_exposure p``
and ``--tbptt N`` select the carried-state training regimes
(``TrainConfig.carry_exposure``, ``TrainConfig.tbptt_chain``);
``--eval_modes carry history reset`` the streaming statefulness under
eval. ``--save_params DIR`` writes each family's trained state as a port
checkpoint (``DIR/<family>/state.pt``, ``training/checkpoint.py``), and
``--load_params DIR`` evaluates those without training.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from ode_vio_tpu_torch.config import (Config, DataConfig, ModelConfig, SolverConfig,
                                      TrainConfig, resolve_device)
from ode_vio_tpu_torch.data.evaluation import KittiEvaluator
from ode_vio_tpu_torch.data.kitti import (BoundarySafeBatchSampler, KittiDataset,
                                          StreamingChainSampler, collate)
from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
from ode_vio_tpu_torch.data.transforms import Center, Compose
from ode_vio_tpu_torch.models.deepvio import DeepVIO, create_model
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
from ode_vio_tpu_torch.training.loop import (create_train_state, make_infer_fn,
                                             make_streaming_train_step, make_train_step,
                                             set_learning_rate)

TRAIN_SEQS = ("00", "01")
EVAL_SEQ = "05"
IMG_HW = (64, 128)


def build_config(family: str) -> Config:
    """The experiment's configuration of ``family`` (a pose core)."""
    return Config(
        model=ModelConfig(model_type=family, img_w=IMG_HW[1], img_h=IMG_HW[0], seq_len=11,
                          v_f_len=64, i_f_len=64, ode_hidden_dim=128, rnn_num_layers=2,
                          compute_dtype="float32"),
        solver=SolverConfig(max_steps=32, max_steps_train=16, dt0=1e-2),
        train=TrainConfig(batch_size=8, lr_warmup=1e-3, seed=0),
        data=DataConfig(seq_len=11),
    )


def train_family(family: str, root, epochs: int, dropout: float, dropout_std: float,
                 seed: int, device, lr: float = 1e-3, lr_fine: float | None = None,
                 carry_exposure: float = 0.0, tbptt_chain: int = 0):
    """Train ``family`` from the seed's init on the tree's training
    sequences; returns the train state and the training's wall seconds."""
    if tbptt_chain and carry_exposure > 0.0:
        raise ValueError("--tbptt and --carry_exposure are mutually exclusive "
                         "(TrainConfig.__post_init__ rationale)")
    cfg = build_config(family)
    model = create_model(cfg, seed=seed, device=device, train=True)
    state = create_train_state(cfg, model, seed=seed + 1, device=device)
    set_learning_rate(state.optimizer, lr)
    if tbptt_chain:
        # full-sequence TBPTT: sequence-ordered chains, the hidden state
        # carried across steps (the streaming regime)
        stream_step = make_streaming_train_step(cfg, device=device)
    else:
        fresh_step = step = make_train_step(cfg, device=device)
    carried_step = (make_train_step(cfg, carry=True, device=device)
                    if carry_exposure > 0.0 else None)

    t0 = time.perf_counter()
    last_losses = []
    fine_from = int(epochs * 2 / 3)
    for epoch in range(epochs):
        if lr_fine is not None and epoch == fine_from:
            # a miniature of the reference's phase schedule: the fine rate
            # for the last third
            set_learning_rate(state.optimizer, lr_fine)
            print(f"# {family} epoch {epoch}: lr -> {lr_fine}", flush=True)
        rng = np.random.default_rng(seed * 100003 + epoch)
        if carried_step is not None:
            # the exposure's draws from (seed, epoch), as cli.train draws them
            ce_rng = np.random.default_rng(seed * 100003 + epoch + 0xCA44)

            def step(state, *batch, _rng=ce_rng):
                if _rng.random() < carry_exposure:
                    return carried_step(state, *batch)
                return fresh_step(state, *batch)

        ratio = float(np.clip(rng.normal(dropout, dropout_std), 0, 0.9))
        ds = KittiDataset(root, cfg.data.seq_len, list(TRAIN_SEQS),
                          transform=Compose([Center()]), dropout=ratio, rng=rng)
        if tbptt_chain:
            sampler = StreamingChainSampler(ds.seq_num_windows, cfg.train.batch_size,
                                            tbptt_chain, stride=cfg.data.seq_len - 1,
                                            seed=seed + epoch)
        else:
            sampler = BoundarySafeBatchSampler(len(ds), cfg.train.batch_size,
                                               seed=seed + epoch, drop_last=True)
        losses, hc = [], None
        for it, idx in enumerate(sampler):
            b = collate([ds[i] for i in idx])
            if tbptt_chain:
                if it % tbptt_chain == 0:
                    hc = None
                state, m, hc = stream_step(state, *b, hc)
            else:
                state, m = step(state, *b)
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        if epoch == 0 or epoch == epochs - 1 or (epoch + 1) % 5 == 0:
            print(f"# {family} epoch {epoch}: loss {np.mean(losses):.5f} "
                  f"(dropout {ratio:.2f})", flush=True)
        last_losses = losses
    seconds = time.perf_counter() - t0
    print(f"# {family}: trained {epochs} epochs in {seconds:.1f}s, "
          f"final loss {np.mean(last_losses):.5f}", flush=True)
    return state, seconds


def eval_family(family: str, model: DeepVIO, root, eval_dropouts, run_times: int, seed: int,
                device, streaming_mode: str = "carry") -> list:
    """The rows of ``model`` at each eval dropout: mean and std over
    ``run_times`` of t_rel, r_rel, t_rmse, r_rmse on the eval sequence."""
    sd = model.state_dict()
    if streaming_mode != "carry":
        # 'history' is the reference's cde/rde eval; 'reset' the stateless
        # training regime. The weights do not depend on the mode.
        cfg = dataclasses.replace(model.cfg, cde_streaming_mode=streaming_mode,
                                  rde_streaming_mode=streaming_mode)
        model = DeepVIO(cfg, model.solver, model.cde_solver)
    infer = make_infer_fn(model, sd, device=device)
    if streaming_mode == "reset":
        # every family without a streaming-mode field carries an RNN
        # state: drop the carry so every window starts fresh
        inner = infer

        def infer(img, imu, ts, carry=None, active=None):
            return inner(img, imu, ts, None, active)

        for attr in ("incomplete", "incomplete_by_lane", "reset_incomplete",
                     "set_variables", "device"):
            setattr(infer, attr, getattr(inner, attr))
    rows = []
    for q in eval_dropouts:
        per_run = {k: [] for k in ("t_rel", "r_rel", "t_rmse", "r_rmse")}
        for r in range(run_times):
            ev = KittiEvaluator(root, val_seqs=(EVAL_SEQ,), seq_len=11, img_hw=IMG_HW,
                                eval_dropout=q, rng=np.random.default_rng(seed + 7919 * (r + 1)))
            res = ev.eval(infer)[0]
            for k in per_run:
                per_run[k].append(float(res[k]))
        row = {"family": family, "eval_dropout": q, "runs": run_times, "mode": streaming_mode}
        for k, v in per_run.items():
            row[k] = round(float(np.mean(v)), 4)
            row[k + "_std"] = round(float(np.std(v)), 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def summary(rows: list) -> list:
    """JAX's summary table: each row's metric and its ratio to the
    family's own 0 %-dropout point (t_rel where every row has it, else
    t_rmse, which short synthetic paths need)."""
    key = "t_rel" if all(np.isfinite(r["t_rel"]) for r in rows) else "t_rmse"
    rkey = "r_rel" if key == "t_rel" else "r_rmse"
    lines = [f"# family/mode | eval_dropout | {key} | {rkey} | {key} vs own 0%"]
    base = {(r["family"], r["mode"]): r[key] for r in rows if r["eval_dropout"] == 0.0}
    for r in rows:
        k = (r["family"], r["mode"])
        rel = r[key] / base[k] if base.get(k) else float("nan")
        lines.append(f"# {r['family']:8s}/{r['mode']:7s} | {r['eval_dropout']:.1f} | "
                     f"{r[key]:8.3f} | {r[rkey]:7.3f} | {rel:6.2f}x")
    return lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", nargs="+", default=["ode-rnn", "rnn"])
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--train_dropout", type=float, default=0.3)
    ap.add_argument("--train_dropout_std", type=float, default=0.1)
    ap.add_argument("--eval_dropouts", nargs="+", type=float, default=[0.0, 0.3, 0.5, 0.7])
    ap.add_argument("--run_times", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr_fine", type=float, default=None,
                    help="learning rate for the last third of the epochs (a miniature of "
                         "the reference's warmup/joint/fine schedule)")
    ap.add_argument("--n_frames", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", type=str, default=None,
                    help="reuse (or write) the synthetic tree here")
    ap.add_argument("--eval_modes", nargs="+", default=["carry"],
                    choices=["carry", "history", "reset"],
                    help="streaming-eval statefulness to evaluate (the reference's "
                         "cde/rde eval is 'history'; 'carry' is the default)")
    ap.add_argument("--carry_exposure", type=float, default=0.0,
                    help="probability that a train step takes the carried (split) window "
                         "(TrainConfig.carry_exposure)")
    ap.add_argument("--tbptt", type=int, default=0,
                    help="full-sequence TBPTT chain length: windows in sequence order, "
                         "the hidden state carried across N train steps "
                         "(TrainConfig.tbptt_chain); 0 = off")
    ap.add_argument("--save_params", type=str, default=None,
                    help="directory to write each family's trained state into, as "
                         "<dir>/<family>/state.pt (re-evaluate without training)")
    ap.add_argument("--load_params", type=str, default=None,
                    help="a directory from --save_params: families found there are "
                         "evaluated without training")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    return ap


def main(argv=None) -> list:
    """Run the experiment; returns every row."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tree_kw = dict(seqs=(*TRAIN_SEQS, EVAL_SEQ), n_frames=args.n_frames, img_hw=IMG_HW,
                   imu_mode="odometric", speed_scale=10.0, seed=args.seed + 11)
    own_tree = args.tree is None
    root = Path(tempfile.mkdtemp(prefix="kitti_irr_")) if own_tree else Path(args.tree)
    try:
        if not (root / "poses").exists():
            make_kitti_tree(root, **tree_kw)
        print(f"# synthetic odometric tree at {root}", flush=True)
        rows = []
        for family in args.families:
            loaded = (CheckpointManager(args.load_params) if args.load_params else None)
            if loaded is not None and loaded.path(family).exists():
                model = create_model(build_config(family), device=device)
                model.load_state_dict(loaded.restore_raw(family)["model"], strict=True)
                print(f"# {family}: loaded trained params from {loaded.path(family)}",
                      flush=True)
            else:
                state, _ = train_family(
                    family, root, args.epochs, args.train_dropout, args.train_dropout_std,
                    args.seed, device, lr=args.lr, lr_fine=args.lr_fine,
                    carry_exposure=args.carry_exposure, tbptt_chain=args.tbptt)
                if args.save_params:
                    CheckpointManager(args.save_params).save(family, state)
                model = state.model
            for mode in args.eval_modes:
                rows += eval_family(family, model, root, args.eval_dropouts, args.run_times,
                                    args.seed, device, streaming_mode=mode)
    finally:
        if own_tree:
            shutil.rmtree(root, ignore_errors=True)
    print()
    print("\n".join(summary(rows)), flush=True)
    return rows


if __name__ == "__main__":
    main()
