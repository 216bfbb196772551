"""The port's top-level entry points (``ode_vio_tpu_torch/entry.py``) and its
launch lines (``ode_vio_tpu_torch/launch/*.sh``) against the JAX
repository's (``__graft_entry__.py``, ``scripts/run_*.sh``).

* :func:`build_forward` at the tiny widths of ``torch_port_helpers.TINY``
  in float32 from bridged JAX weights (random BatchNorm statistics),
  against JAX's ``model.apply`` in eval mode: poses within atol 1e-4, the
  serving slice's tolerance (float32 through the encoders, the adaptive
  solves and the RNN stack, sums taken in another order); through the
  solver core and through K1's wrapper (its plain version on the CPU).
* ``entry(device="cpu")`` at flagship width with JAX's seed-0 weights
  loaded against JAX's ``entry()`` (slow, like
  tests/test_flagship_parity.py).
* Every ``python -m`` line of the two launch scripts, commented
  alternatives included, parsed by the port's ``cli/flags.py`` into the
  ``Config`` that JAX's ``config_from_args`` makes of the matching line of
  ``scripts/run_*.sh`` (``use_pallas`` read as ``use_kernels``).

``dryrun_multichip`` is held in tests/test_torch_port_mesh.py, in its
world of four ranks."""

import dataclasses
import importlib
import re
import shlex
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.cli import flags as jax_flags
from ode_vio_tpu_torch.cli import flags as port_flags
from ode_vio_tpu_torch.entry import build_forward, example_batch
from ode_vio_tpu_torch.models.convert import from_jax_variables

from torch_port_helpers import configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = Path(__file__).resolve().parent.parent
POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """The tiny model in both packages, and JAX's poses on the batch-2
    example (eval mode)."""
    jc, tc = configs()
    model, v = jax_model(jc)
    img, imu, ts = (x.numpy() for x in example_batch(tc, 2))
    poses, _ = model.apply(v, jnp.asarray(img), jnp.asarray(imu), jnp.asarray(ts), train=False,
                           rngs={"gumbel": jax.random.PRNGKey(0)})
    return tc, v, (img, imu, ts), np.asarray(poses)


def test_example_batch_is_jax_example_batch():
    """The same draws as JAX's ``_example_batch``, bit for bit."""
    import __graft_entry__ as ge

    jc, tc = configs()
    for got, want in zip(example_batch(tc, 3), ge._example_batch(jc, 3)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernels", [None, True])
def test_build_forward_matches_jax_at_tiny_width(tiny, use_kernels):
    """``fn(img, imu, ts)`` of the tiny configuration from the bridged
    weights against JAX's eval-mode forward; the model is in eval mode, and
    the example is one window."""
    tc, v, (img, imu, ts), want = tiny
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, use_kernels=use_kernels))
    fn, example = build_forward(tc, device="cpu")
    fn.model.load_state_dict(from_jax_variables(v, tc.model), strict=True)
    assert not fn.model.training
    got = fn(*(torch.from_numpy(x) for x in (img, imu, ts)))
    assert got.shape == want.shape == (2, tc.model.seq_len - 1, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POSE_ATOL)
    assert [tuple(x.shape) for x in example] == [(1, *x.shape[1:]) for x in (img, imu, ts)]
    assert all(x.device.type == "cpu" for x in example)


@pytest.mark.slow
def test_entry_matches_jax_entry():
    """``entry(device="cpu")`` with JAX's seed-0 flagship weights loaded
    against JAX's ``entry()`` on its batch-1 example (the same example bit
    for bit). The flagship encoders run in bf16, where the two frameworks
    round the convs at other places (tests/test_torch_port_modules.py:
    2e-2 of the features' scale); the poses are held within 2e-2 of their
    largest magnitude (6.1e-3 of it measured)."""
    import __graft_entry__ as ge
    from ode_vio_tpu.config import flagship_config as jax_flagship
    from ode_vio_tpu.models.deepvio import init_model

    from ode_vio_tpu_torch.entry import entry

    jfn, jargs = ge.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = entry(device="cpu")
    for got, ref in zip(args, jargs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _, variables = init_model(jax_flagship(), jax.random.PRNGKey(0), batch_size=1)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    fn.model.load_state_dict(from_jax_variables(variables, fn.model.cfg), strict=True)
    got = fn(*args).numpy()
    assert got.shape == want.shape == (1, 10, 6) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the launch lines
# ---------------------------------------------------------------------------

def script_commands(path: Path) -> list:
    """Each ``python -m`` command of the shell script ``path``, commented
    ones too, as ``(module, argv)``: continuation lines joined, the
    script's ``VAR=${VAR:-default}`` variables and ``${X:-default}`` read as
    their defaults, ``"$@"`` dropped, and a ``for X in a b ...; do`` loop's
    commands once for each value."""
    text = path.read_text()
    defaults = dict(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}$", text, re.M))
    loops = dict((k, v.split()) for k, v in re.findall(r"for (\w+) in ([^;]+);", text))
    commands, current = [], None
    for line in text.splitlines():
        body = re.sub(r"^#\s?", "", line.strip())
        if current is None and body.startswith("python -m "):
            current = ""
        if current is None:
            continue
        current += " " + body.rstrip("\\").strip()
        if not body.endswith("\\"):
            commands.append(current.strip())
            current = None
    out = []
    for cmd in commands:
        cmd = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", cmd).replace('"$@"', "")
        names = [k for k in loops if f"${k}" in cmd or f"${{{k}}}" in cmd] or [None]
        for value in (loops[names[0]] if names[0] else [None]):
            c = cmd
            for k, d in defaults.items():
                c = c.replace(f"${{{k}}}", d).replace(f"${k}", d)
            if value is not None:
                c = c.replace(f"${{{names[0]}}}", value).replace(f"${names[0]}", value)
            argv = shlex.split(c)
            out.append((argv[2], argv[3:]))
    return out


def as_config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)

    def norm(x):
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        return x

    return norm(d)


@pytest.mark.parametrize("script", ["run_training.sh", "run_testing.sh"])
def test_launch_lines_build_jax_configs(script):
    """The port's launch script has JAX's commands in JAX's order (its
    command lines for JAX's), and each builds, through the port's
    parser, every field of the port's Config as JAX's parser builds it
    from the JAX line (use_kernels from use_pallas)."""
    ours = script_commands(ROOT / "ode_vio_tpu_torch" / "launch" / script)
    theirs = script_commands(ROOT / "scripts" / script)
    assert len(ours) == len(theirs) >= (5 if script == "run_testing.sh" else 4)
    for (mod, argv), (jmod, jargv) in zip(ours, theirs):
        assert mod == jmod.replace("ode_vio_tpu.", "ode_vio_tpu_torch.")
        assert argv == jargv
        importlib.import_module(mod)  # the command line exists
        got = as_config_dict(port_flags.config_from_args(port_flags.build_parser().parse_args(argv)))
        want = as_config_dict(jax_flags.config_from_args(jax_flags.build_parser().parse_args(jargv)))
        want["model"]["use_kernels"] = want["model"].pop("use_pallas")
        for section, fields in got.items():
            if isinstance(fields, dict):
                assert fields == {k: want[section][k] for k in fields}, (mod, section)
            else:
                assert fields == want[section], (mod, section)
