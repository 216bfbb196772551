"""Checkpoints of a training run (counterpart of
``ode_vio_tpu/training/checkpoint.py``, which writes Orbax directories).

Each checkpoint is a directory ``<directory>/<name>/`` holding one
``torch.save`` file, ``state.pt``, with everything a resumed run needs: the
model's ``state_dict`` (weights and BatchNorm statistics, in the
reference layout), the ``Optimizer``'s full state (moments, step counts,
accumulation), ``TrainState.step`` and the state of the train state's
generator. Metadata (epoch, best t_rel) go beside it as
``<name>.meta.json``. Epoch checkpoints are named ``epoch_%03d``, so
:meth:`CheckpointManager.latest_epoch` finds the newest as JAX's does.
Restoring into a fresh :class:`TrainState` gives bitwise the state that
was saved. Under data parallelism (``parallel/mesh.py``) the ranks hold
one state bit for bit: rank 0 writes it, every rank waits for the write
at a barrier, and every rank restores from the file.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import TYPE_CHECKING, Optional

import torch

from ode_vio_tpu_torch.parallel.mesh import barrier, is_rank0

if TYPE_CHECKING:
    from ode_vio_tpu_torch.training.loop import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        """The file that holds checkpoint ``name``."""
        return self.directory / name / STATE_FILE

    def save(self, name: str, state: TrainState, metadata: Optional[dict] = None) -> None:
        """Write ``state`` under ``directory/name`` (replacing what was
        there), and ``metadata`` as ``name.meta.json``; every rank of a
        process group calls it, rank 0 writes and the others wait."""
        if is_rank0():
            self._write(name, state, metadata)
        barrier()

    def _write(self, name: str, state: TrainState, metadata: Optional[dict]) -> None:
        path = self.path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step,
                    "generator": state.generator.get_state()}, tmp)
        os.replace(tmp, path)
        if metadata is not None:
            (self.directory / f"{name}.meta.json").write_text(json.dumps(metadata, default=str))

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Load checkpoint ``name`` into ``state`` (its model, optimizer,
        step and generator) in place, and return it."""
        raw = self.restore_raw(name)
        state.model.load_state_dict(raw["model"], strict=True)
        state.optimizer.load_state_dict(raw["optimizer"])
        state.step = raw["step"]
        state.generator.set_state(raw["generator"])
        return state

    def restore_raw(self, name: str) -> dict:
        """Checkpoint ``name`` as saved (CPU tensors): ``model``,
        ``optimizer``, ``step``, ``generator``."""
        return torch.load(self.path(name), map_location="cpu", weights_only=True)

    def metadata(self, name: str) -> Optional[dict]:
        p = self.directory / f"{name}.meta.json"
        return json.loads(p.read_text()) if p.exists() else None

    def latest_epoch(self) -> Optional[int]:
        eps = [int(p.name.split("_")[1]) for p in self.directory.glob("epoch_*")
               if p.is_dir() and p.name.split("_")[1].isdigit()]
        return max(eps) if eps else None

    def epoch_name(self, epoch: int) -> str:
        return f"epoch_{epoch:03d}"
