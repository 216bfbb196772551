"""Weight bridge: JAX variables -> the port's reference-layout state_dict.

:func:`from_jax_variables` takes the JAX model's ``{'params',
'batch_stats'}`` tree as nested dicts (and lists) of numpy arrays and
returns the tensors that ``DeepVIO.load_state_dict(strict=True)``
accepts. Layout rules (those of ``ode_vio_tpu/models/convert.py``):

* Conv2d kernels HWIO -> OIHW; Conv1d kernels KIO -> OIK.
* Dense kernels (in, out) -> Linear weights (out, in).
* ``visual_head`` rows come in the JAX HWC flatten order and go to the
  reference's CHW order; ``proj`` rows come L-major (11, 256) and go
  C-major (256, 11).
* The MLP and RNN-cell params are already in the torch (out, in) layout.
* The cde/rde cores: ``cde_func`` -> ``cde_func.net.{2i}``, ``initial`` ->
  ``initial.0``, ``reduction0``/``reduction1`` -> ``reduction_net.0``/``.2``
  (cde), ``reduction`` -> ``reduction_net`` (rde).
* The ode-rnn and rnn stacks: layer k's ``w_ih``/``w_hh``/``b_ih``/``b_hh``
  -> ``rnn.weight_ih_l{k}``... The CfC cell -> ``rnn.rnn_cell.backbone.0``,
  ``ff1``, ``ff2``, ``time_a``, ``time_b``; the LTC cell -> ``rnn.w_x``,
  ``rnn.w_h``, ``rnn.log_tau``, ``rnn.A`` (the keys JAX's
  ``export_pose_net`` writes).
* BatchNorm scale/bias/mean/var map to weight/bias/running_mean/
  running_var, plus a zero ``num_batches_tracked``. A BN-folded tree (no
  bn entries, conv biases present) converts too.

:func:`load_pretrain` is the ``--pretrain`` of the command lines: a
reference-layout checkpoint file (a torch ``.pth``/``.tar``/``.pt``, or
the ``.npz`` that ``python -m ode_vio_tpu.cli.export`` writes) is already
the port's state_dict layout, so it is structure-checked and loaded with
``strict=True``, nothing converted. A directory of the port's own
checkpoints (``training/checkpoint.py``, as ``cli.train`` writes them)
loads its latest epoch, else ``best``, as JAX's ``cli.test`` picks.

:func:`load_flownet` is ``--pretrain_flownet``: a torch FlowNet-S
state_dict mapped onto ``Image_net.*`` by key intersection (JAX's
``convert_image_encoder``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ode_vio_tpu_torch.config import ModelConfig
from ode_vio_tpu_torch.models.encoders import IMU_CHANNELS, IMU_FREQ, TRUNK_NAMES, trunk_out_hw


def _rows_to_cmajor(w: np.ndarray, c: int, h: int, wd: int) -> np.ndarray:
    """Rows of ``w`` in (h, w, c) order -> (c, h, w) order."""
    return w.reshape(h, wd, c, -1).transpose(2, 0, 1, 3).reshape(c * h * wd, -1)


def _bn(sd: dict, key: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{key}.weight"] = params["scale"]
    sd[f"{key}.bias"] = params["bias"]
    sd[f"{key}.running_mean"] = stats["mean"]
    sd[f"{key}.running_var"] = stats["var"]
    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _dense(sd: dict, key: str, dense: Mapping) -> None:
    sd[f"{key}.weight"] = np.asarray(dense["kernel"]).T
    sd[f"{key}.bias"] = dense["bias"]


def _mlp(sd: dict, key: str, layers) -> None:
    for i, layer in enumerate(layers):
        sd[f"{key}.{2 * i}.weight"] = layer["w"]
        sd[f"{key}.{2 * i}.bias"] = layer["b"]


def _lin(sd: dict, key: str, lin: Mapping) -> None:
    sd[f"{key}.weight"] = lin["w"]
    sd[f"{key}.bias"] = lin["b"]


def from_jax_variables(variables: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, Any] = {}

    img, img_s = params["image_encoder"], stats.get("image_encoder", {})
    for i, name in enumerate(TRUNK_NAMES):
        block = img[f"block{i}"]
        sd[f"Image_net.{name}.0.weight"] = np.asarray(block["conv"]["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in block["conv"]:
            sd[f"Image_net.{name}.0.bias"] = block["conv"]["bias"]
        if "bn" in block:
            _bn(sd, f"Image_net.{name}.1", block["bn"], img_s[f"block{i}"]["bn"])
    h, wd = trunk_out_hw(cfg.img_h, cfg.img_w)
    head = np.asarray(img["visual_head"]["kernel"])
    sd["Image_net.visual_head.weight"] = _rows_to_cmajor(head, head.shape[0] // (h * wd), h, wd).T
    sd["Image_net.visual_head.bias"] = img["visual_head"]["bias"]

    imu, imu_s = params["inertial_encoder"], stats.get("inertial_encoder", {})
    for j in range(len(IMU_CHANNELS)):
        conv = f"Inertial_net.encoder_conv.{4 * j}"
        sd[f"{conv}.weight"] = np.asarray(imu[f"conv{j}"]["kernel"]).transpose(2, 1, 0)
        sd[f"{conv}.bias"] = imu[f"conv{j}"]["bias"]
        if f"bn{j}" in imu:
            _bn(sd, f"Inertial_net.encoder_conv.{4 * j + 1}", imu[f"bn{j}"], imu_s[f"bn{j}"])
    proj = np.asarray(imu["proj"]["kernel"])
    sd["Inertial_net.proj.weight"] = _rows_to_cmajor(proj, IMU_CHANNELS[-1], 1, IMU_FREQ + 1).T
    sd["Inertial_net.proj.bias"] = imu["proj"]["bias"]

    pose = params["pose_net"]
    if "fuse" in pose:
        _dense(sd, "Pose_net.fuse.net.0", pose["fuse"]["gate"])
    if cfg.model_type in ("ode-rnn", "rnn"):
        if cfg.model_type == "ode-rnn":
            _mlp(sd, "Pose_net.ode_func.net", pose["ode_func"])
        for k, cell in enumerate(pose["rnn"]):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"Pose_net.rnn.{theirs}_l{k}"] = cell[ours]
    elif cfg.model_type == "cfc":
        cell = pose["cfc"]
        _lin(sd, "Pose_net.rnn.rnn_cell.backbone.0", cell["backbone"])
        for name in ("ff1", "ff2", "time_a", "time_b"):
            _lin(sd, f"Pose_net.rnn.rnn_cell.{name}", cell[name])
    elif cfg.model_type == "ltc":
        cell = pose["ltc"]
        _lin(sd, "Pose_net.rnn.w_x", cell["w_x"])
        _lin(sd, "Pose_net.rnn.w_h", cell["w_h"])
        sd["Pose_net.rnn.log_tau"] = cell["log_tau"]
        sd["Pose_net.rnn.A"] = cell["A"]
    else:  # cde, rde
        _mlp(sd, "Pose_net.cde_func.net", pose["cde_func"])
        _dense(sd, "Pose_net.initial.0", pose["initial"])
        if cfg.model_type == "cde":
            _dense(sd, "Pose_net.reduction_net.0", pose["reduction0"])
            _dense(sd, "Pose_net.reduction_net.2", pose["reduction1"])
        else:
            _dense(sd, "Pose_net.reduction_net", pose["reduction"])
    _dense(sd, "Pose_net.regressor.0", pose["regressor"]["fc0"])
    _dense(sd, "Pose_net.regressor.2", pose["regressor"]["fc1"])

    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def load_reference_file(path) -> Dict[str, torch.Tensor]:
    """A reference-layout checkpoint file as a state_dict of CPU tensors:
    ``.npz`` through numpy, anything else through ``torch.load`` (a bare
    state_dict or a dict holding one under ``state_dict``)."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def check_structure(sd: Mapping[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise ``SystemExit`` with a readable message when a checkpoint does
    not match the model the flags built (wrong ``--model_type``, widths or
    layer counts) instead of a shape error further down."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got == want:
        return
    missing = sorted(set(want) - set(got))[:5]
    extra = sorted(set(got) - set(want))[:5]
    shape = sorted(f"{k}: ckpt{got[k]} != model{want[k]}"
                   for k in set(got) & set(want) if got[k] != want[k])[:5]
    raise SystemExit(
        "the checkpoint does not match the model flags: "
        f"missing {missing} extra {extra} shape-mismatch {shape}")


def require_port_checkpoint(ckpt, name: str) -> None:
    """``SystemExit`` with the ``cli.export`` hint where checkpoint ``name``
    of ``ckpt`` (a ``CheckpointManager``) is not the port's: a JAX
    package's checkpoints directory holds Orbax ``epoch_*`` directories."""
    if not ckpt.path(name).is_file():
        raise SystemExit(
            f"--pretrain {ckpt.directory} is a directory without a checkpoint of "
            f"the port ({name}/state.pt): a JAX (Orbax) TrainState checkpoint, "
            "which the port cannot read. Convert it with `python -m "
            "ode_vio_tpu.cli.export --pretrain <dir> --out model.npz` (same "
            "model flags) and pass the .npz file, or pass a checkpoints "
            "directory that the port's cli.train wrote (training/checkpoint.py).")


def load_pretrain(model: torch.nn.Module, path) -> str:
    """Load a reference-layout checkpoint file, or the weights of a port
    checkpoints directory's latest epoch (else ``best``), into ``model``
    (strict). BatchNorm ``num_batches_tracked`` counters, which the JAX
    package's export leaves out, are taken as 0; inference never reads
    them. Returns what was loaded."""
    path = Path(path)
    if path.is_dir():
        from ode_vio_tpu_torch.training.checkpoint import CheckpointManager

        ckpt = CheckpointManager(path)
        latest = ckpt.latest_epoch()
        name = ckpt.epoch_name(latest) if latest is not None else "best"
        require_port_checkpoint(ckpt, name)
        sd = ckpt.restore_raw(name)["model"]
        path = path / name
    elif path.is_file():
        sd = load_reference_file(path)
    else:
        raise SystemExit(f"--pretrain {path}: no such file")
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v, device="cpu")
    check_structure(sd, model)
    model.load_state_dict(sd, strict=True)
    return str(path)


def load_flownet(model: torch.nn.Module, path) -> List[str]:
    """``--pretrain_flownet``: load a torch FlowNet-S checkpoint into
    ``model.Image_net`` by key intersection, as the JAX package's
    ``convert_image_encoder`` does: each trunk block whose conv weight the
    file holds (with its BatchNorm's weight, bias and running statistics),
    and ``visual_head`` where present; every other key of the file is
    ignored. The port's image encoder is in the reference's layout (OIHW
    convs, the head's inputs in CHW order), so nothing is permuted. Returns
    the loaded keys."""
    sd = load_reference_file(path)
    own = model.Image_net.state_dict()
    new = {}
    for name in TRUNK_NAMES:
        if f"{name}.0.weight" in sd:
            for k in ("0.weight", "1.weight", "1.bias", "1.running_mean", "1.running_var"):
                new[f"{name}.{k}"] = sd[f"{name}.{k}"]
    if "visual_head.weight" in sd:
        for k in ("visual_head.weight", "visual_head.bias"):
            new[k] = sd[k]
    model.Image_net.load_state_dict(
        {**own, **{k: v.to(own[k].dtype) for k, v in new.items()}}, strict=True)
    return sorted(new)
