"""Checkpoint export: ``python -m ode_vio_tpu_torch.cli.export --pretrain
<checkpoints dir> --out model.pth`` (counterpart of
``ode_vio_tpu/cli/export.py``).

Writes the weights of a checkpoints directory of the port's ``cli.train``
(its latest epoch, else ``best``; training/checkpoint.py) as a
reference-layout state_dict, the one the reference's torch tooling loads
(``scripts/test_model.py:106-108``) and the JAX package's
``convert_deepvio`` reads. The port's state_dict is already in that layout;
the export is its tensors as contiguous float32 on the CPU, with the key set
of the JAX package's ``export_deepvio``: without BatchNorm's
``num_batches_tracked``.

Output formats (chosen by the ``--out`` suffix):
  * ``.npz``  -- numpy archive; load in torch with
    ``{k: torch.from_numpy(v) for k, v in np.load(path).items()}``.
  * ``.pth``  -- ``torch.save`` of the dict of tensors.

The model is built by the same flags as ``cli.train``'s and loaded on
``--device`` (default ``cuda``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.config import resolve_device
from ode_vio_tpu_torch.models.convert import load_pretrain
from ode_vio_tpu_torch.models.deepvio import create_model


def export_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict as the JAX package's ``export_deepvio`` keys
    it: contiguous float32 CPU tensors, no ``num_batches_tracked``."""
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--out", type=str, required=True,
                        help="output path (.npz torch-free, or .pth)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.pretrain or not Path(cfg.pretrain).is_dir():
        parser.error("--pretrain (checkpoint directory) is required")
    device = resolve_device(args.device)

    model = create_model(cfg, seed=cfg.train.seed, device=device)
    source = load_pretrain(model, cfg.pretrain)
    sd = export_state_dict(model)
    if str(args.out).endswith(".pth"):
        torch.save(sd, args.out)
    else:
        np.savez(args.out, **{k: v.numpy() for k, v in sd.items()})
    print(f"exported {len(sd)} tensors ({cfg.model.model_type}) "
          f"from {source} -> {args.out}")
    return sd


if __name__ == "__main__":
    main()
