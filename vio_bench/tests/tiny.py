"""A tiny cell for the benchmark's CPU tests: the flagship's structure at
widths a CPU runs in seconds, float32 encoders, two to four sessions."""

import copy
import json

from vio_bench.harness import BENCH_DIR

TINY_MODEL = {"img_h": 32, "img_w": 64, "v_f_len": 32, "i_f_len": 16, "ode_hidden_dim": 16,
              "cde_hidden_dim": 8, "compute_dtype": "float32"}


def tiny_cell(config: str = "odevio-odernn", sessions: int = 3, limit: float = 1e-3,
              **model) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    cfg["model"].update(TINY_MODEL, **model)
    mix = json.loads((BENCH_DIR / "traffic" / "mixes" / "live-s8.json").read_text())
    mix.update(sessions=sessions, pool_windows=4, drain_s=5, stage_every=2)
    return {"name": "serve-odernn-live" if config == "odevio-odernn" else "serve-rnn-s8",
            "config": config, "traffic": "live-s8", "chips": 1, "why": "test",
            "limits": {"pose_gap": limit, "feature_gap": limit, "core_gap": limit / 10},
            "config_file": cfg, "mix": mix}


def loader(cell):
    return lambda name: copy.deepcopy(cell)


def tiny_eval_cell(limit: float = 1e-3) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / "odevio-odernn.json").read_text())
    cfg["model"].update(TINY_MODEL)
    mix = json.loads((BENCH_DIR / "traffic" / "mixes" / "kitti3x2.json").read_text())
    mix.update(seqs=["05", "07"], n_frames=30, raw_hw=[40, 130])
    return {"name": "eval-odernn-seq", "config": "odevio-odernn", "traffic": "kitti3x2",
            "chips": 1, "why": "test",
            "limits": {"pose_gap": limit, "feature_gap": limit, "core_gap": limit / 10},
            "config_file": cfg, "mix": mix}
