"""The JAX repository's learning checks (``tests/test_convergence.py``) on
the port: a tiny ode-rnn DeepVIO trained on sequence 00 of a synthetic
KITTI tree, its streaming-eval pose RMSE (t_rmse + r_rmse on sequence 05)
taken before and after. Two recipes, JAX's own:

* ``plain``: the default fixture (IMU as band-limited noise), 40 frames,
  4 epochs at lr 3e-4 -- the loss must fall and the eval RMSE with it;
* ``odometric``: the odometry-consistent fixture
  (``data/synthetic.py::make_imu_odometric``: the IMU determines the
  relative pose), 80 frames, seed 3, 10 epochs at lr 1e-3 -- the eval
  RMSE must fall below half its untrained value.

The thresholds are the callers' (tests/test_torch_port_convergence.py and
``chip_smoke.py``'s learn phase). The model trains with the image encoder
in train mode, its trunk dropout through kernel K3, and evaluates its
solves through kernel K1 where the device is a card.
"""

from __future__ import annotations

import time
from pathlib import Path

from ode_vio_tpu_torch.config import Config, DataConfig, ModelConfig, SolverConfig, TrainConfig
from ode_vio_tpu_torch.data.evaluation import KittiEvaluator
from ode_vio_tpu_torch.data.kitti import BoundarySafeBatchSampler, KittiDataset, collate
from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
from ode_vio_tpu_torch.data.transforms import Center, Compose
from ode_vio_tpu_torch.models.deepvio import create_model
from ode_vio_tpu_torch.training.loop import (create_train_state, make_infer_fn, make_train_step,
                                             set_learning_rate)

SEQ_LEN, IMG_HW, BATCH = 4, (32, 64), 8
# recipe -> the tree's make_kitti_tree arguments, the learning rate, epochs
RECIPES = {
    "plain": (dict(seqs=("00", "05"), n_frames=40, img_hw=IMG_HW), 3e-4, 4),
    "odometric": (dict(seqs=("00", "05"), n_frames=80, img_hw=IMG_HW, imu_mode="odometric",
                       seed=3), 1e-3, 10),
}


def tiny_config(lr: float) -> Config:
    """JAX's tiny ode-rnn of the learning checks."""
    return Config(
        model=ModelConfig(model_type="ode-rnn", img_w=IMG_HW[1], img_h=IMG_HW[0],
                          seq_len=SEQ_LEN, v_f_len=32, i_f_len=16, ode_hidden_dim=16,
                          rnn_num_layers=2, compute_dtype="float32"),
        solver=SolverConfig(max_steps=8, max_steps_train=8, dt0=1e-2),
        train=TrainConfig(batch_size=BATCH, lr_warmup=lr),
        data=DataConfig(seq_len=SEQ_LEN),
    )


def make_tree(recipe: str, directory) -> Path:
    """The recipe's synthetic KITTI tree under ``directory``."""
    return make_kitti_tree(directory, **RECIPES[recipe][0])


def eval_rmse(model, root, device) -> float:
    """t_rmse + r_rmse of the streaming eval of sequence 05."""
    ev = KittiEvaluator(root, val_seqs=("05",), seq_len=SEQ_LEN, img_hw=IMG_HW)
    res = ev.eval(make_infer_fn(model, device=device))
    return res[0]["t_rmse"] + res[0]["r_rmse"]


def learn(recipe: str, root, device="cuda") -> dict:
    """Train the recipe's model (seed-0 weights, the train state's
    generator seeded with 1) on sequence 00 of ``root``, batches of 8
    shuffled with the epoch as seed, the last partial batch dropped.
    Returns the eval RMSE ``before`` and ``after``, every step's loss,
    and the training's wall seconds."""
    _, lr, epochs = RECIPES[recipe]
    cfg = tiny_config(lr)
    model = create_model(cfg, seed=0, device=device, train=True)
    before = eval_rmse(model, root, device)
    ds = KittiDataset(root, SEQ_LEN, ["00"], transform=Compose([Center()]))
    state = create_train_state(cfg, model, seed=1, device=device)
    set_learning_rate(state.optimizer, lr)
    step = make_train_step(cfg, device=device)
    losses = []
    t = time.perf_counter()
    for epoch in range(epochs):
        for idx in BoundarySafeBatchSampler(len(ds), BATCH, seed=epoch, drop_last=True):
            state, m = step(state, *collate([ds[i] for i in idx]))
            losses.append(m["loss"])
    losses = [float(x) for x in losses]
    seconds = time.perf_counter() - t
    return {"recipe": recipe, "before": before, "after": eval_rmse(state.model, root, device),
            "losses": losses, "train_seconds": seconds, "epochs": epochs}
