"""Offline multi-method trajectory comparison plots.

The port's copy of ``ode_vio_tpu/cli/plot.py`` (the reference's
``scripts/plot_prediction_pose_graph.py:18-96``): overlay ground truth and
any number of predicted trajectories (KITTI-format pose txt dumps, e.g.
written by cli.test / KittiEvaluator.save_text). Needs matplotlib.

    python -m ode_vio_tpu_torch.cli.plot --gt results/.../05_gt.txt \
        --pred ODE-VIO=results/.../05_pred.txt RNN=other/05_pred.txt \
        --out 05_compare.png
"""

from __future__ import annotations

import argparse
from pathlib import Path


from ode_vio_tpu_torch.utils.geometry import read_pose_file


def plot_trajectories(gt_path, preds: dict, out_path, title="trajectory"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7), dpi=120)
    gt, _ = read_pose_file(gt_path)
    ax.plot(gt[:, 0, 3], gt[:, 2, 3], "r-", linewidth=1.5,
            label="Ground Truth")
    styles = ["b-", "g--", "m-.", "c:", "y-"]
    for (name, path), style in zip(preds.items(), styles):
        est, _ = read_pose_file(path)
        ax.plot(est[:, 0, 3], est[:, 2, 3], style, linewidth=1.2, label=name)
    ax.plot(0, 0, "ko", label="Start")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=9)
    ax.set_title(title)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt", type=str, required=True,
                   help="ground-truth KITTI pose txt")
    p.add_argument("--pred", type=str, nargs="+", default=[],
                   help="NAME=path pairs of predicted pose txt files")
    p.add_argument("--out", type=str, default="trajectory_compare.png")
    p.add_argument("--title", type=str, default="trajectory")
    args = p.parse_args(argv)
    preds = dict(item.split("=", 1) for item in args.pred)
    out = plot_trajectories(args.gt, preds, args.out, args.title)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
