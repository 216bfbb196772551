"""One-command accuracy-parity harness:
``python -m ode_vio_tpu_torch.cli.parity --ref_ckpt ode-vio-v1.pth
--data_dir dataset --val_seq 05 07 10`` (counterpart of
``ode_vio_tpu/cli/parity.py``).

Loads a reference checkpoint (.pth / .tar, or an ``.npz`` export) into the
model the flags build, runs the port's streaming KITTI tester (the
protocol of the reference's ``scripts/test_model.py:91-153``) ``--run_times``
times and reports t_rel / r_rel per sequence, optionally next to
reference-side numbers from either

* ``--torch_protocol`` -- the pure-torch replica of the reference stack
  (reference/torch_tester.py) on the SAME decoded windows, so the delta
  isolates the model stacks, or
* ``--ref_metrics metrics.json`` -- a recorded
  ``{"05": {"t_rel": ..., "r_rel": ...}, ...}`` measured by running the
  actual reference repo elsewhere.

Output: one JSON line with per-sequence ours/reference/delta, plus a
human-readable table on stderr. Exit code 1 if ``--max_delta_pct`` is set
and any |delta| exceeds it. Both testers run on ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.data.evaluation import METRICS, EvalPartition, KittiEvaluator
from ode_vio_tpu_torch.models.convert import load_checked, load_reference_file
from ode_vio_tpu_torch.models.deepvio import create_model
from ode_vio_tpu_torch.training.loop import make_infer_fn


def parity_parser():
    p = build_parser()
    p.add_argument("--ref_ckpt", type=str, required=True,
                   help="reference torch checkpoint (.pth / .tar, or .npz)")
    p.add_argument("--torch_protocol", action="store_true",
                   help="also run the torch reference-protocol tester "
                        "(slow at full KITTI scale)")
    p.add_argument("--ref_metrics", type=str, default=None,
                   help="JSON file of reference-side per-seq metrics")
    p.add_argument("--max_delta_pct", type=float, default=None,
                   help="fail (exit 1) if any |relative delta| exceeds "
                        "this percentage")
    return p


def _mean_metrics(runs, seqs):
    """Per-sequence mean over repeated runs -> {seq: {t_rel, r_rel, ...}}."""
    return {s: {k: float(np.mean([r[i][k] for r in runs])) for k in METRICS}
            for i, s in enumerate(seqs)}


def main(argv=None):
    args = parity_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    seqs = list(cfg.data.val_seq)

    # --- the reference checkpoint, checked against the flags' model -----
    sd = load_reference_file(args.ref_ckpt)
    model = create_model(cfg, seed=cfg.train.seed, device=device)
    load_checked(model, sd)

    # --- our side: streaming tester, run_times repetitions -------------
    infer = make_infer_fn(model, fold_bn=not args.no_fold_bn, device=device)
    runs = []
    for run in range(cfg.run_times):
        evaluator = KittiEvaluator(
            cfg.data.data_dir, seqs, cfg.data.seq_len,
            (cfg.model.img_h, cfg.model.img_w), cfg.data.eval_data_dropout,
            rng=np.random.default_rng(cfg.train.seed + run),
        )
        runs.append(evaluator.eval(infer))
    ours = _mean_metrics(runs, seqs)

    # --- reference side -------------------------------------------------
    ref = None
    ref_source = None
    if args.ref_metrics:
        with open(args.ref_metrics) as f:
            ref = json.load(f)
        ref_source = "recorded"
    elif args.torch_protocol:
        from ode_vio_tpu_torch.reference.torch_tester import (
            build_reference_model, load_state, protocol_eval,
        )

        t_model = build_reference_model(cfg, device)
        load_state(t_model, sd)
        ref = {}
        for s in seqs:
            part = EvalPartition(
                cfg.data.data_dir, s, cfg.data.seq_len,
                (cfg.model.img_h, cfg.model.img_w),
                cfg.data.eval_data_dropout,
                rng=np.random.default_rng(cfg.train.seed),
            )
            m = protocol_eval(t_model, part, device)
            ref[s] = {k: float(m[k]) for k in METRICS}
        ref_source = "torch_protocol"

    # --- report ----------------------------------------------------------
    rows = []
    worst = 0.0
    for s in seqs:
        row = {"seq": s, "ours": ours[s]}
        if ref and s in ref:
            row["ref"] = ref[s]
            row["delta_pct"] = {
                k: (100.0 * (ours[s][k] - ref[s][k])
                    / max(abs(ref[s][k]), 1e-9))
                for k in ("t_rel", "r_rel") if k in ref[s]
            }
            worst = max(worst, *(abs(v) for v in row["delta_pct"].values()))
        rows.append(row)

    hdr = f"{'seq':>4} {'t_rel%':>10} {'r_rel':>10}"
    if ref:
        hdr += f" {'ref t_rel%':>10} {'ref r_rel':>10} {'dt_rel%':>8} {'dr_rel%':>8}"
    print(hdr, file=sys.stderr)
    for row in rows:
        o = row["ours"]
        line = f"{row['seq']:>4} {o['t_rel']:>10.4f} {o['r_rel']:>10.4f}"
        if "ref" in row:
            r, d = row["ref"], row["delta_pct"]
            line += (f" {r['t_rel']:>10.4f} {r['r_rel']:>10.4f}"
                     f" {d['t_rel']:>8.2f} {d['r_rel']:>8.2f}")
        print(line, file=sys.stderr)

    report = {
        "checkpoint": args.ref_ckpt,
        "model_type": cfg.model.model_type,
        "eval_data_dropout": cfg.data.eval_data_dropout,
        "run_times": cfg.run_times,
        "ref_source": ref_source,
        "rows": rows,
    }
    if ref:
        report["worst_delta_pct"] = worst
    print(json.dumps(report))

    if args.max_delta_pct is not None and ref and worst > args.max_delta_pct:
        print(f"FAIL: worst delta {worst:.2f}% > {args.max_delta_pct}%",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
