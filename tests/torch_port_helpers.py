"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_port_*):
one tiny model configuration built in both packages, seeded JAX variables
with non-trivial BatchNorm statistics, and numpy windows."""

import jax
import numpy as np

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


def jax_model(jax_config, seed=0):
    model, variables = init_model(jax_config, jax.random.PRNGKey(seed))
    return model, randomize_batchnorm(variables, seed)


def window(seed, t0=0.0, s=S, h=H, w=W):
    rng = np.random.default_rng(seed)
    imgs = rng.random((s, h, w, 3), np.float32) - 0.5
    imus = rng.standard_normal((10 * (s - 1) + 1, 6)).astype(np.float32)
    ts = t0 + np.cumsum(rng.uniform(0.08, 0.13, s)).astype(np.float32)
    return imgs, imus, ts


def batch(seeds, **kw):
    wins = [window(sd, **kw) for sd in seeds]
    return tuple(np.stack([w[k] for w in wins]) for k in range(3))
