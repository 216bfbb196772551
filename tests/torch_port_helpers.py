"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_port_*):
one tiny model configuration built in both packages, seeded JAX variables
with non-trivial BatchNorm statistics, numpy windows, and a fixture that
runs torch on one thread."""

import jax
import numpy as np
import pytest
import torch

from ode_vio_tpu import config as jcfg
from ode_vio_tpu.models.deepvio import init_model
from ode_vio_tpu_torch import config as tcfg

S, H, W = 3, 64, 128
TINY = dict(model_type="ode-rnn", img_w=W, img_h=H, seq_len=S, v_f_len=64,
            i_f_len=32, ode_hidden_dim=32, rnn_num_layers=2,
            ode_activation_fn="softplus", ode_fn_num_layers=2,
            fuse_method="soft", compute_dtype="float32")


def configs(**overrides):
    """(JAX Config, port Config) with the same model and solver fields."""
    model = dict(TINY, **overrides)
    return (jcfg.Config(model=jcfg.ModelConfig(**model),
                        data=jcfg.DataConfig(seq_len=model["seq_len"])),
            tcfg.Config(model=tcfg.ModelConfig(**model)))


def randomize_batchnorm(variables, seed=0):
    """Replace the init's identity BatchNorms (scale 1, bias 0, mean 0,
    var 1) with random ones, so that BN and its folding are exercised."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    def walk(p, s):
        for k in p:
            if k.startswith("bn") and k in s:
                n = p[k]["scale"].shape[0]
                p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)}
                s[k] = {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


# (JAX config, seed) -> (model, variables): a worker of the suite runs
# several port files, and most of them start from the same tiny model
_JAX_MODELS = {}


def jax_model(jax_config, seed=0):
    """The JAX model of ``jax_config`` and its variables from
    ``PRNGKey(seed)`` with random BatchNorms. The init runs once a process
    for each configuration and seed; every call gets its own copy of the
    variables."""
    key = (jax_config, seed)
    if key not in _JAX_MODELS:
        model, variables = init_model(jax_config, jax.random.PRNGKey(seed))
        _JAX_MODELS[key] = (model, randomize_batchnorm(variables, seed))
    model, variables = _JAX_MODELS[key]
    return model, jax.tree_util.tree_map(np.copy, variables)


def window(seed, t0=0.0, s=S, h=H, w=W):
    rng = np.random.default_rng(seed)
    imgs = rng.random((s, h, w, 3), np.float32) - 0.5
    imus = rng.standard_normal((10 * (s - 1) + 1, 6)).astype(np.float32)
    ts = t0 + np.cumsum(rng.uniform(0.08, 0.13, s)).astype(np.float32)
    return imgs, imus, ts


def batch(seeds, **kw):
    wins = [window(sd, **kw) for sd in seeds]
    return tuple(np.stack([w[k] for w in wins]) for k in range(3))


@pytest.fixture(scope="module", autouse=False)
def one_torch_thread():
    """torch on one intra-op thread for a module's tests. Their tiny shapes
    gain nothing from the thread pool, and with the suite's parallel
    workers on every core each op waits for a descheduled thread: a
    cli.train split-run test took 25 s on one thread and over 90 s on
    eight, beside seven busy processes on an 8-core host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
