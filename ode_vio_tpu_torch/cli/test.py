"""Evaluation entry point: ``python -m ode_vio_tpu_torch.cli.test --pretrain ...``
(a reference-layout checkpoint file, or a checkpoints directory of
``cli.train``)

The port's counterpart of ``ode_vio_tpu/cli/test.py`` (the reference's
``scripts/test_model.py:91-153`` protocol): repeats the full streaming
KITTI evaluation ``--run_times`` times (re-rolling the stochastic eval
frame-dropout each repeat), sequentially or, with ``--batch_runs``, as
the lanes of one stream, and writes per-sequence mean +/- std to
``summary.txt``, KITTI-format pose dumps and, where matplotlib is
installed, trajectory plots. Runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import numpy as np

from ode_vio_tpu_torch.cli.flags import (
    build_model,
    build_parser,
    check_eval_dp,
    config_from_args,
)
from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.data.evaluation import (
    KittiEvaluator,
    eval_runs,
    summarize_runs,
)
from ode_vio_tpu_torch.training.loop import make_infer_fn
from ode_vio_tpu_torch.utils.logging_utils import (
    setup_experiment_directories,
    setup_logger,
)


def write_plots(evaluator: KittiEvaluator, graphs, logger, tag: str = "") -> None:
    """Trajectory plots, or one warning where matplotlib is not installed
    (the summary and pose dumps do not need it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.warning("matplotlib is not installed: no trajectory plots "
                       "written")
        return
    evaluator.generate_plots(graphs, tag=tag)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    check_eval_dp(args.eval_dp, device)
    dirs = setup_experiment_directories(cfg.save_dir, cfg.experiment_name + "_test")
    logger = setup_logger(f"test_{cfg.experiment_name}", dirs["logs"])

    model = build_model(cfg, device, logger, "evaluating")
    # BN statistics are frozen at eval: fold them into the conv weights
    # (exact; models/fold.py) unless explicitly disabled
    infer = make_infer_fn(model, fold_bn=not args.no_fold_bn, device=device)

    def make_evaluator(run: int) -> KittiEvaluator:
        return KittiEvaluator(
            cfg.data.data_dir, cfg.data.val_seq, cfg.data.seq_len,
            (cfg.model.img_h, cfg.model.img_w), cfg.data.eval_data_dropout,
            rng=np.random.default_rng(cfg.train.seed + run),
        )

    if args.batch_runs:
        # every (run, sequence) pair is one lane of a single stream
        evaluators = [make_evaluator(run) for run in range(cfg.run_times)]
        all_runs = eval_runs(infer, evaluators)
        for run, errors in enumerate(all_runs):
            logger.info("run %d: %s", run, errors)
        write_plots(evaluators[0], dirs["graphs"], logger)
        evaluators[0].save_text(dirs["poses"])
    else:
        all_runs = []
        for run in range(cfg.run_times):
            evaluator = make_evaluator(run)
            errors = evaluator.eval(infer)
            all_runs.append(errors)
            logger.info("run %d: %s", run, errors)
            if run == 0:
                write_plots(evaluator, dirs["graphs"], logger)
                evaluator.save_text(dirs["poses"])

    if infer.incomplete() > 0:
        logger.warning(
            "%d ODE solves hit the step budget before t1 across all runs "
            "(truncated; raise ode_max_steps)", infer.incomplete(),
        )
    summary = summarize_runs(all_runs, cfg.data.val_seq)
    (dirs["base"] / "summary.txt").write_text(summary + "\n")
    logger.info("summary:\n%s", summary)


if __name__ == "__main__":
    main()
