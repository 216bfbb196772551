"""The JAX repository's learning checks (tests/test_convergence.py) on
the port, with their recipes and thresholds
(``ode_vio_tpu_torch/experiments/convergence.py``): a short synthetic
training run must lower the streaming-eval pose RMSE against the
untrained model, end to end through train step, evaluator and metric, on
the CPU. Both are slow, as JAX's are."""

import numpy as np
import pytest

from ode_vio_tpu_torch.experiments.convergence import learn, make_tree

from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.slow
def test_training_improves_eval_rmse(tmp_path_factory):
    """The plain fixture: the last step's loss below 0.8 of the first's,
    and the eval RMSE lower than untrained."""
    root = make_tree("plain", tmp_path_factory.mktemp("kitti_cv"))
    out = learn("plain", root, device="cpu")
    losses = out["losses"]
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert out["after"] < out["before"], (out["before"], out["after"])
    assert np.isfinite(out["after"])


@pytest.mark.slow
def test_odometric_fixture_learns_odometry(tmp_path_factory):
    """On the odometry-consistent fixture (the IMU determines the relative
    pose) training must drive the eval RMSE below half the untrained
    model's: the port learns odometry end to end, not only the mean step."""
    root = make_tree("odometric", tmp_path_factory.mktemp("kitti_odo"))
    out = learn("odometric", root, device="cpu")
    assert np.isfinite(out["after"])
    assert out["after"] < 0.5 * out["before"], (out["before"], out["after"])
