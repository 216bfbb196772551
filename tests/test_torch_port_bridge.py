"""The port's weight bridge (models/convert.py::from_jax_variables) and
BatchNorm fold (models/fold.py) against the JAX package's export_deepvio
and fold_batchnorm_into_bias."""

import dataclasses

import numpy as np
import pytest
import torch

from ode_vio_tpu.models.convert import export_deepvio, trunk_out_hw
from ode_vio_tpu.models.fold import fold_batchnorm_into_bias as jax_fold
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.fold import fold_batchnorm_into_bias

from torch_port_helpers import configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=["cat", "soft", "hard"])
def bridged(request):
    jc, tc = configs(fuse_method=request.param)
    _, variables = jax_model(jc)
    return tc, variables, from_jax_variables(variables, tc.model)


def test_keys_and_values_equal_export_deepvio(bridged):
    tc, variables, sd = bridged
    ref = export_deepvio(variables, "ode-rnn",
                         conv_out_hw=trunk_out_hw(tc.model.img_h, tc.model.img_w))
    ours = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_strict_load_and_state_dict_roundtrip(bridged):
    tc, _, sd = bridged
    model = DeepVIO(tc.model, tc.solver)
    model.load_state_dict(sd, strict=True)
    back = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_fold_matches_jax_fold(bridged):
    """Same f32 formula on both sides; XLA may contract (b - mean)*s + beta
    into one FMA, so allow a few ulp."""
    tc, variables, sd = bridged
    folded = fold_batchnorm_into_bias(sd)
    ref = from_jax_variables(jax_fold(variables), tc.model)
    assert sorted(folded) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(folded[k], ref[k], rtol=1e-6, atol=1e-7, msg=k)
    skip_bn = DeepVIO(dataclasses.replace(tc.model, skip_bn=True), tc.solver)
    skip_bn.load_state_dict(folded, strict=True)
