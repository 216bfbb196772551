"""The training step, its optimiser and schedule, and the streaming-eval
inference callable (counterpart of ``ode_vio_tpu/training/loop.py``).

Training: ``loss = angle_loss_weight * MSE(rotation) + MSE(translation)``
over a window's poses; per param group ("train", and "regressor" when
``lr_regressor`` is set; the frozen image encoder in none) the gradients
are clipped by the group's global norm, weight decay is added to them and
Adam (or SGD with momentum 0.9) steps, as the JAX package's optax chain
does; ``grad_accumulation_steps`` averages that many steps' gradients
before one update (``optax.MultiSteps``). With ``freeze_encoder`` the
image encoder runs under ``torch.no_grad()`` in train mode (batch
statistics, trunk dropout through kernel K3), so autograd records none of
it; with ``frozen_encoder_eval`` on top it runs its BatchNorm-folded
inference graph instead. Every random draw of a step (one key per trunk
dropout site, the Bernoulli masks, hard fusion's noise) comes from the
train state's ``torch.Generator``. The step trains all six pose cores;
the cde/rde cores integrate through the bounded, differentiable CDE solve
and never through kernel K2.

Data parallelism (``parallel/mesh.py``): a step built with a ``mesh``
runs on one rank and takes that rank's rows of the global batch. Its
BatchNorm statistics are the global batch's (``create_train_state`` with
the mesh shares them over the data group, and broadcasts rank 0's state);
the gradients are averaged over the data group as one flat buffer before
the optimizer clips them, so ``grad_norm`` and the update are the global
batch's, and the loss metrics are averaged over it and the truncated
solves summed; every key a step draws is mixed with the rank's data
coordinate (``models/common.py::RankKeys``), from the one generator every
rank holds alike. The step is not wrapped in ``DistributedDataParallel``:
it takes its gradients with ``torch.autograd.grad``, which DDP's reducer
does not hook. With a mesh of one rank nothing of this runs. A state
created with ``split_params`` over a model axis of more than one rank
stores only its slice of each parameter ``param_sharding_rules`` splits
(``parallel/mesh.py::ModelSplit``): the step gathers the whole weights
once, each slice takes its own part of the gradient, moments and
accumulation mean are slices too, and every gradient norm (the clip's
and ``grad_norm``) sums the slices' squares over the model group.

``make_train_step(cfg, carry=True)`` is the carried step of the
carried-state exposure (``TrainConfig.carry_exposure``), and
``make_streaming_train_step`` the full-sequence TBPTT step
(``TrainConfig.tbptt_chain``): the hidden state crosses a window boundary
detached, so the gradient stops there. Checkpoints are
``training/checkpoint.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ode_vio_tpu_torch.config import Config, resolve_device
from ode_vio_tpu_torch.models.common import Carry, LaneDraws, RankKeys
from ode_vio_tpu_torch.models.deepvio import DeepVIO, require_ported
from ode_vio_tpu_torch.models.encoders import ImageEncoder, share_batch_statistics
from ode_vio_tpu_torch.models.fold import fold_batchnorm, fold_batchnorm_into_bias
from ode_vio_tpu_torch.parallel.mesh import (Mesh, ModelSplit, gathered, model_split, replicate,
                                             split_parameters)


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """The step schedule of the learning rate: warmup, joint, fine."""
    t = cfg.train
    if epoch < t.epochs_warmup:
        return t.lr_warmup
    if epoch < t.epochs_warmup + t.epochs_joint:
        return t.lr_joint
    return t.lr_fine


def param_group(name: str, freeze_encoder: bool, split_regressor: bool) -> str:
    """The group of the parameter ``name`` (a ``named_parameters`` name):
    "frozen" (the image encoder under ``freeze_encoder``), "regressor"
    (the pose regressor when it has a learning rate of its own) or
    "train"."""
    parts = name.split(".")
    if freeze_encoder and parts[0] == "Image_net":
        return "frozen"
    if split_regressor and "regressor" in parts:
        return "regressor"
    return "train"


def global_norm(tensors: Iterable[torch.Tensor], axes: Optional[Sequence] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors``. Where
    ``axes`` marks a tensor (an axis, not None) as this rank's slice of one
    split over the model ``group``, the slices' square-sums are summed
    over the group, so that the norm is the whole tensors' and every
    tensor counts once."""
    tensors = list(tensors)
    if axes is None or all(a is None for a in axes):
        return torch.sqrt(sum(torch.sum(g * g) for g in tensors))
    parts = torch.stack([torch.sum(g * g) for g, a in zip(tensors, axes) if a is not None]).sum()
    torch.distributed.all_reduce(parts, group=group)
    return torch.sqrt(sum((torch.sum(g * g) for g, a in zip(tensors, axes) if a is None),
                          parts))


class Optimizer:
    """The counterpart of the JAX package's ``make_optimizer(cfg)``, built
    as ``Optimizer(model, cfg)``: a ``torch.optim`` Adam (b1 0.9,
    b2 0.999, eps 1e-8) or SGD (momentum 0.9) over named param groups, with
    ``weight_decay`` added to the gradients; :meth:`step` clips each
    group's gradients by that group's global norm first, and averages them
    over ``grad_accumulation_steps`` calls before one update. Over a model
    whose parameters are split (``parallel/mesh.py::model_split``) its
    state holds slices, the norms are the whole gradients', and
    :meth:`state_dict` gathers the whole tensors (a collective over the
    model group)."""

    def __init__(self, model: torch.nn.Module, cfg: Config):
        t = cfg.train
        groups: Dict[str, List[torch.nn.Parameter]] = {}
        for name, p in model.named_parameters():
            g = param_group(name, t.freeze_encoder, t.lr_regressor is not None)
            if g != "frozen":
                groups.setdefault(g, []).append(p)
        lrs = {"train": t.lr_warmup, "regressor": t.lr_regressor}
        param_groups = [{"params": ps, "lr": lrs[g], "name": g} for g, ps in groups.items()]
        if t.optimizer.lower() == "sgd":
            self.inner = torch.optim.SGD(param_groups, lr=t.lr_warmup, momentum=0.9,
                                         weight_decay=t.weight_decay)
        else:
            self.inner = torch.optim.Adam(param_groups, lr=t.lr_warmup, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=t.weight_decay)
        self.params: List[torch.nn.Parameter] = [p for g in self.inner.param_groups
                                                 for p in g["params"]]
        self.split: Optional[ModelSplit] = model_split(model)
        # the axis of each parameter that is this rank's slice, else None
        self.axes = [None if self.split is None else self.split.axis_of(p)
                     for p in self.params]
        self.max_norm = t.gradient_clip
        self.every = t.grad_accumulation_steps
        self.mini_step = 0
        self._mean: Optional[List[torch.Tensor]] = None

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One call per train step, with the gradients of :attr:`params`.
        Under accumulation the params change on every ``every``-th call
        only, by the mean of the gradients since the last update."""
        if self.every > 1:
            n = self.mini_step
            if self._mean is None:
                self._mean = [torch.zeros_like(g) for g in grads]
            for m, g in zip(self._mean, grads):
                m.add_((g - m) / (n + 1))
            self.mini_step = (n + 1) % self.every
            if self.mini_step:
                return
            grads, self._mean = self._mean, None
        i = 0
        for group in self.inner.param_groups:
            ps = group["params"]
            gs = grads[i:i + len(ps)]
            norm = self.norm(gs, self.axes[i:i + len(ps)])
            i += len(ps)
            within = norm < self.max_norm  # optax: clip only at or above the limit
            for p, g in zip(ps, gs):
                p.grad = torch.where(within, g, g / norm * self.max_norm)
        self.inner.step()
        for p in self.params:
            p.grad = None

    def norm(self, grads: Sequence[torch.Tensor], axes: Optional[Sequence] = None
             ) -> torch.Tensor:
        """The global norm of ``grads`` (of :attr:`params`, or of the
        parameters ``axes`` belongs to), whole where they are slices."""
        return global_norm(grads, self.axes if axes is None else axes,
                           None if self.split is None else self.split.group)

    def _resized(self, inner: dict, mean, resize) -> tuple:
        """The inner state and the mean with ``resize(t, axis)`` applied to
        every per-element tensor (not a step count) of a split parameter."""
        def one(t, axis):
            return t if axis is None or not torch.is_tensor(t) or t.dim() == 0 else resize(t, axis)

        state = {i: {k: one(v, self.axes[i]) for k, v in st.items()}
                 for i, st in inner["state"].items()}
        return (dict(inner, state=state),
                None if mean is None else [one(m, a) for m, a in zip(mean, self.axes)])

    def state_dict(self) -> dict:
        """What a resumed run needs: the inner optimizer's state (moments,
        step counts, groups), the accumulation position and its running
        mean; the whole tensors where the parameters are split."""
        inner, mean = self.inner.state_dict(), self._mean
        if self.split is not None:
            inner, mean = self._resized(inner, mean, self.split.whole)
        return {"inner": inner, "mini_step": self.mini_step, "mean": mean}

    def load_state_dict(self, sd: dict) -> None:
        inner, mean = sd["inner"], sd["mean"]
        if self.split is not None:
            inner, mean = self._resized(inner, mean,
                                        lambda t, axis: self.split.local(t, axis).clone())
        self.inner.load_state_dict(inner)
        self.mini_step = sd["mini_step"]
        self._mean = None if mean is None else [m.to(p.device) for m, p in zip(mean, self.params)]


def set_learning_rate(optimizer: Optimizer, lr: float, group: str = "train") -> Optimizer:
    """Set one param group's learning rate (the epoch schedule sets the
    "train" group's only); a group the optimizer lacks is a KeyError."""
    names = [g["name"] for g in optimizer.inner.param_groups]
    if group not in names:
        raise KeyError(f"param group '{group}' not in optimizer (have {sorted(names)})")
    optimizer.inner.param_groups[names.index(group)]["lr"] = lr
    return optimizer


@dataclasses.dataclass
class TrainState:
    """The model (in train mode, on its device), its optimizer, the steps
    taken, and the CPU generator every random draw of a step comes from
    (each K3 dropout call takes one 64-bit key of it)."""

    model: DeepVIO
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(cfg: Config, model: DeepVIO, *, seed: Optional[int] = None,
                       device="cuda", mesh: Optional[Mesh] = None,
                       split_params: bool = False) -> TrainState:
    """Move ``model`` to ``device`` in train mode and build its optimizer
    and a generator seeded with ``seed`` (default ``cfg.train.seed``).
    Under a ``mesh`` of several ranks its BatchNorms take the global
    batch's statistics and the state is rank 0's (broadcast); with
    ``split_params`` each rank then keeps only its slice, over the model
    axis, of the parameters ``param_sharding_rules`` splits
    (``parallel/mesh.py::split_parameters``), and the optimizer is built
    over the slices."""
    device = resolve_device(device)
    model = model.to(device).train()
    gen = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    state = TrainState(model, Optimizer(model, cfg), gen)
    if mesh is not None and mesh.size > 1:
        share_batch_statistics(model, mesh.groups["data"])
        replicate(state, mesh)
        if split_params and split_parameters(model, mesh) is not None:
            state.optimizer = Optimizer(model, cfg)
    return state


def detach_carry(hc: Optional[Carry]) -> Optional[Carry]:
    """The carry with every leaf detached: it crosses a window boundary as
    data, so no gradient (and no autograd graph) reaches earlier windows."""
    if hc is None:
        return None
    if isinstance(hc, dict):
        return {k: v.detach() for k, v in hc.items()}
    return hc.detach()


def _step_parts(cfg: Config, device: torch.device, mesh: Optional[Mesh] = None):
    """What every train step shares: ``keys(state)``, the randomness a
    step draws from (the state's generator, or this rank's
    :class:`RankKeys` of it), ``features(model, img, gen)``, the visual
    features as the configuration computes them (the frozen encoder's
    folded inference graph, the frozen encoder in train mode under
    no_grad, or the trained encoder), ``update(state, poses, gts,
    incomplete)``, which takes the loss, its gradients (averaged over the
    mesh's data group) and the optimizer step and returns the metrics,
    and ``inputs``."""
    t = cfg.train
    group = None if mesh is None else mesh.groups["data"]

    def keys(state: TrainState):
        if group is None:
            return state.generator
        return RankKeys(state.generator, mesh.coords["data"])
    # the fold targets the plain conv; the int8 and s2d encoders keep their own
    m = cfg.model
    frozen_eval = (t.freeze_encoder and t.frozen_encoder_eval
                   and not (m.encoder_int8 or m.encoder_s2d or m.skip_bn))
    if frozen_eval:
        with torch.device("meta"):
            eval_image_net = ImageEncoder(dataclasses.replace(cfg.model, skip_bn=True))
        eval_image_net = eval_image_net.to_empty(device=device).eval()

    def features(model: DeepVIO, img: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if frozen_eval:
            # the frozen encoder's inference graph, folded from its current
            # statistics, which it then leaves unchanged
            with torch.no_grad():
                eval_image_net.load_state_dict(
                    fold_batchnorm_into_bias(model.Image_net.state_dict()))
                return eval_image_net(img)
        if t.freeze_encoder:
            with torch.no_grad():
                return model.Image_net(img, gen)
        return model.Image_net(img, gen)

    def update(state: TrainState, poses, gts, incomplete) -> Dict:
        angle = torch.mean((poses[..., :3] - gts[..., :3]) ** 2)
        trans = torch.mean((poses[..., 3:] - gts[..., 3:]) ** 2)
        loss = t.angle_loss_weight * angle + trans
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = (loss.detach(), angle.detach(), trans.detach())
        if group is not None:
            grads, metrics, incomplete = _global_mean(grads, metrics, incomplete, group)
        grad_norm = state.optimizer.norm(grads)
        state.optimizer.step(grads)
        state.step += 1
        return {"loss": metrics[0], "angle_loss": metrics[1], "trans_loss": metrics[2],
                "grad_norm": grad_norm, "solver_incomplete": incomplete}

    def inputs(img, imu, gts, ts):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (img, imu, gts, ts))

    return keys, features, update, inputs


def _global_mean(grads, metrics, incomplete, group):
    """The gradients and loss metrics averaged over the data ``group``
    (the gradients as one flat buffer) and the truncated solves summed."""
    n = torch.distributed.get_world_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= n
    grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    packet = torch.stack([*(m.double() for m in metrics), incomplete.double()])
    torch.distributed.all_reduce(packet, group=group)
    metrics = tuple((packet[i] / n).float() for i in range(len(metrics)))
    return grads, metrics, packet[-1].to(incomplete.dtype)


def carry_split(cfg: Config) -> int:
    """The carried step's splice frame ``k``: ``carry_split`` or
    ``(S-1)//2``. ValueError where a segment would hold fewer than
    ``min_seg`` pose steps (2 for the path-based cde/rde cores, whose
    one-knot path has no segment to interpolate, else 1)."""
    S = cfg.model.seq_len
    k = cfg.train.carry_split or (S - 1) // 2
    min_seg = 2 if cfg.model.model_type in ("cde", "rde") else 1
    if not min_seg <= k <= S - 1 - min_seg:
        raise ValueError(
            f"carry_split={k} out of range [{min_seg}, {S - 1 - min_seg}] for "
            f"model_type={cfg.model.model_type} at seq_len={S} (each segment "
            f"needs >= {min_seg} pose steps)")
    return k


def make_train_step(cfg: Config, carry: bool = False, *, device="cuda",
                    mesh: Optional[Mesh] = None) -> Callable:
    """Build ``train_step(state, img, imu, gts, ts) -> (state, metrics)``:
    one forward, backward and optimizer update of ``state`` in place, on
    ``device``. Inputs in the JAX package's layout (numpy or tensors): img
    (B, S, H, W, 3), imu (B, 10*(S-1)+1, 6), gts (B, S-1, 6), ts (B, S).
    ``metrics`` holds device tensors: ``loss``, ``angle_loss``,
    ``trans_loss``, ``grad_norm`` (of this step's unclipped gradients) and
    ``solver_incomplete`` (solves that ran out of ``max_steps_train``:
    per layer and frame interval for ode-rnn, per segment for cde/rde; 0
    for the rnn, cfc and ltc cores, which solve nothing). Beyond the
    solver's early-exit checks nothing waits for the device.

    With ``carry`` the step trains the carried regime
    (``carry_exposure``): the visual features are computed once over the
    window; segment 1 (pose steps ``0..k-1``, :func:`carry_split`) runs
    fresh, its final hidden state is detached and seeds segment 2 (pose
    steps ``k..S-2``), and the loss covers both segments' poses. The
    inertial encoder runs once per segment, so its BatchNorm statistics
    move twice.

    Under a ``mesh`` of several ranks the step takes this rank's rows of
    the global batch (``parallel/mesh.py::shard_batch``) and ``state``
    from ``create_train_state`` with the same mesh; the module docstring
    says what the ranks share."""
    device = resolve_device(device)
    require_ported(cfg.model.model_type)
    keys, features, update, inputs = _step_parts(cfg, device, mesh)
    k = carry_split(cfg) if carry else None

    def train_step(state: TrainState, img, imu, gts, ts) -> Tuple[TrainState, Dict]:
        model, gen = state.model, keys(state)
        img, imu, gts, ts = inputs(img, imu, gts, ts)
        with gathered(model):
            fv = features(model, img, gen)
            if k is None:
                poses, _, stats = model.pose_from_visual(fv, imu, ts, generator=gen)
                incomplete = stats.incomplete.sum()
            else:
                p1, hc, st1 = model.pose_from_visual(fv[:, :k], imu[:, :10 * k + 1],
                                                     ts[:, :k + 1], generator=gen)
                p2, _, st2 = model.pose_from_visual(fv[:, k:], imu[:, 10 * k:], ts[:, k:],
                                                    detach_carry(hc), generator=gen)
                poses = torch.cat([p1, p2], dim=1)
                incomplete = st1.incomplete.sum() + st2.incomplete.sum()
            return state, update(state, poses, gts, incomplete)

    return train_step


def make_streaming_train_step(cfg: Config, *, device="cuda",
                              mesh: Optional[Mesh] = None) -> Callable:
    """Build the full-sequence TBPTT step ``step(state, img, imu, gts, ts,
    hc=None) -> (state, metrics, hc_out)``: the train step of
    :func:`make_train_step` from the carried hidden state ``hc`` (``None``
    starts a chain cold and is the fresh step). ``hc_out``, the window's
    final hidden state, comes back detached leaf by leaf, so the next
    window's gradient stops at the boundary (a window-length truncation
    horizon; the state's horizon is the chain). The caller resets the
    carry every ``tbptt_chain`` steps, where ``StreamingChainSampler``
    starts its chains. A ``mesh`` is as in :func:`make_train_step`; ``hc``
    holds this rank's rows."""
    device = resolve_device(device)
    require_ported(cfg.model.model_type)
    keys, features, update, inputs = _step_parts(cfg, device, mesh)

    def step(state: TrainState, img, imu, gts, ts, hc: Optional[Carry] = None):
        model, gen = state.model, keys(state)
        img, imu, gts, ts = inputs(img, imu, gts, ts)
        with gathered(model):
            fv = features(model, img, gen)
            poses, h_T, stats = model.pose_from_visual(fv, imu, ts, hc, generator=gen)
            metrics = update(state, poses, gts, stats.incomplete.sum())
        return state, metrics, detach_carry(h_T)

    return step


def make_infer_fn(model: DeepVIO, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  fold_bn: bool = False, *, device="cuda") -> Callable:
    """Build ``infer(img, imu, ts, carry=None, active=None, lanes=None) ->
    (poses, carry)`` on ``device``: the cold-start call without a carry,
    the carried call with one.

    The callable holds its own copy of the model, loaded from
    ``state_dict`` (default: ``model.state_dict()``). ``fold_bn=True``
    folds the BatchNorm statistics into the conv weights and biases
    (models/fold.py) and builds that copy with ``skip_bn=True``, so no
    BatchNorm runs; with ``encoder_int8`` or ``encoder_s2d``, whose convs
    are not the plain one, it folds by value and keeps the BatchNorms as
    identity plus shift (the int8 conv then quantizes the folded kernel).
    ``infer.set_variables(state_dict)`` swaps the weights, and
    ``infer.replicate(device)`` is a callable like it on ``device`` with
    its weights.

    Truncated solves are counted on the device per batch lane:
    ``infer.incomplete()`` is the running total and
    ``infer.incomplete_by_lane()`` the per-lane vector. ``active``, a
    boolean lane mask, keeps lanes that serve no real window out of the
    counts. Hard fusion draws its Gumbel noise from a generator seeded
    with 0 on every call, as the JAX callable applies ``PRNGKey(0)``;
    ``lanes=(start, total)`` says that the call's lanes are
    ``start..start+B`` of ``total`` (``parallel/lanes.py::split_lanes``),
    and the noise is drawn for all ``total`` and sliced. ``infer.device`` is the device
    its inputs must be on.
    """
    device = resolve_device(device)
    cfg = model.cfg
    strip_bn = fold_bn and not (cfg.encoder_int8 or cfg.encoder_s2d or cfg.skip_bn)
    if strip_bn:
        cfg = dataclasses.replace(cfg, skip_bn=True)
    fold = fold_batchnorm_into_bias if strip_bn else fold_batchnorm if fold_bn else dict
    sd = model.state_dict() if state_dict is None else state_dict
    return _infer_fn(cfg, model.solver, model.cde_solver, fold(sd), fold, device, {})


def _infer_fn(cfg, solver, cde_solver, folded: Dict[str, torch.Tensor], fold: Callable,
              device: torch.device, counts: dict) -> Callable:
    """:func:`make_infer_fn`'s callable over a model of ``cfg`` on
    ``device`` holding the already folded ``folded``. ``counts`` holds,
    per callable made from one :func:`make_infer_fn` (it and its
    replicas), its truncated solves and per-lane vector: ``incomplete()``
    and ``reset_incomplete()`` cover them all."""
    me = len(counts)
    with torch.device("meta"):
        net = DeepVIO(cfg, solver, cde_solver)
    net = net.to_empty(device=device).eval()
    net.load_state_dict(folded, strict=True)

    def set_variables(sd: Dict[str, torch.Tensor]) -> None:
        net.load_state_dict(fold(sd), strict=True)

    hard = cfg.fuse_method == "hard"

    @torch.inference_mode()
    def infer(img, imu, ts, carry=None, active=None, lanes=None):
        gen = None
        if hard:
            gen = torch.Generator(device).manual_seed(0)
            if lanes is not None:
                gen = LaneDraws(gen, *lanes)
        poses, carry, stats = net(img, imu, ts, carry, generator=gen)
        inc = stats.incomplete
        if active is not None:
            inc = inc * torch.as_tensor(np.asarray(active), device=device).to(inc.dtype)
        mine = counts[me]
        mine["total"] += inc.sum()
        if mine["lanes"] is None or mine["lanes"].shape != inc.shape:
            mine["lanes"] = inc.clone()  # lane layout changed: restart
        else:
            mine["lanes"] += inc
        return poses, carry

    def reset_incomplete() -> None:
        for c in counts.values():
            c.update(total=torch.zeros((), dtype=torch.int64, device=c["device"]), lanes=None)

    counts[me] = {"device": device}
    reset_incomplete()
    infer.incomplete = lambda: sum(int(c["total"]) for c in counts.values())
    infer.incomplete_by_lane = lambda: (
        None if counts[me]["lanes"] is None else counts[me]["lanes"].cpu().numpy())
    infer.reset_incomplete = reset_incomplete
    infer.set_variables = set_variables
    infer.replicate = lambda dev: _infer_fn(cfg, solver, cde_solver, net.state_dict(), fold,
                                            resolve_device(dev), counts)
    infer.device = device
    return infer
