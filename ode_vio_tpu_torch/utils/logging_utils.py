"""Experiment directories, dual loggers and tensor diagnostics: the
port's copy of ``ode_vio_tpu/utils/logging_utils.py`` (the reference's
``utils/utils.py:7-87``, without its hard-coded checkpoint path), with
:func:`log_tensor_stats` taking torch tensors."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import torch


def setup_experiment_directories(save_dir, experiment_name: str) -> dict:
    """results/<name>/{checkpoints,logs,graphs,poses} tree."""
    base = Path(save_dir) / experiment_name
    dirs = {
        k: base / k for k in ("checkpoints", "logs", "graphs", "poses")
    }
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    dirs["base"] = base
    return dirs


def setup_logger(name: str, log_dir, level=logging.INFO,
                 console: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    fh = logging.FileHandler(str(Path(log_dir) / f"{name}.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if console:
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    return logger


def log_tensor_stats(x, name: str, logger: logging.Logger) -> None:
    """NaN/Inf and distribution diagnostics (utils/utils.py:75-87)."""
    x = torch.as_tensor(x).detach()
    f = x.double()
    logger.debug(
        "%s: shape=%s dtype=%s min=%g max=%g mean=%g std=%g nan=%s inf=%s",
        name, tuple(x.shape), x.dtype, float(f.min()), float(f.max()),
        float(f.mean()), float(f.std(correction=0)),
        bool(torch.isnan(f).any()), bool(torch.isinf(f).any()),
    )
