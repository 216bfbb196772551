"""Training through the port's continuous adjoint, fixed-step and Adams
solves at the model level: the ode-rnn and cde pose cores' ``--adjoint``
gradients against the JAX package's, at the widths
``tests/test_adjoint_models.py::tiny`` builds (32x64 images, seq_len 3,
features 16/8, ODE hidden 12, CDE hidden 6, float32, solver rtol 1e-5 /
atol 1e-8, dt0 1e-2, training budget 64); the port's adjoint gradients
against its own bounded (discretize-then-optimize) gradients at that
test's tolerance; and ``cli.train`` with ``--adjoint`` and with
``--ode_fixed_step --cde_solver implicit_adams``.

Against JAX the pose core runs from the same inertial-encoder input and
visual features (``pose_from_visual`` in train mode: batch statistics, no
dropout anywhere, so no random bits differ). Tolerance: rtol 1e-4 and an
absolute floor of each tensor's largest entry times 1e-5 (ode-rnn) or
3e-5 (cde): the solvers' rtol 1e-5 sets how far a step decision flipped
by rounding (XLA's FMAs) moves a gradient, and the CDE's landings on its
knots are decided by rounding (ROADMAP.md Queue 3): one BatchNorm bias
entry of the cde step moved by 1.05e-5 of its tensor's largest."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.models.convert import convert_deepvio, trunk_out_hw
from ode_vio_tpu.models.deepvio import DeepVIO as JaxDeepVIO
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.cli.train import main as train_main
from ode_vio_tpu_torch.models import pose_odernn
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO, create_model
from ode_vio_tpu_torch.ops import interpolation
from ode_vio_tpu_torch.ops.solvers import odeint

from test_adjoint_models import batch, tiny
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FIELD = {"ode-rnn": "Pose_net.ode_func.", "cde": "Pose_net.cde_func."}
FLOOR = {"ode-rnn": 1e-5, "cde": 3e-5}  # times each tensor's largest entry


def port_config(jc):
    """The port's Config with the fields of JAX's Config ``jc``."""
    pick = lambda cls, src: cls(**{f.name: getattr(src, f.name)  # noqa: E731
                                   for f in dataclasses.fields(cls) if hasattr(src, f.name)})
    return tcfg.Config(model=pick(tcfg.ModelConfig, jc.model),
                       solver=pick(tcfg.SolverConfig, jc.solver),
                       cde_solver_cfg=pick(tcfg.SolverConfig, jc.cde_solver_cfg))


def port_model(jc, variables):
    tc = port_config(jc)
    model = DeepVIO(tc.model, tc.solver, tc.cde_solver_cfg)
    model.load_state_dict(from_jax_variables(variables, tc.model), strict=True)
    return model.train()


@pytest.fixture(scope="module", params=["ode-rnn", "cde"])
def reference(request):
    """JAX's adjoint gradients of sum(poses^2) through ``pose_from_visual``
    in train mode, for every parameter and for the visual features."""
    mt = request.param
    jc = tiny(mt, adjoint=True)
    # the port's seeded init read by JAX's convert_deepvio (no JAX init)
    sd = create_model(port_config(jc), seed=0, device="cpu").state_dict()
    v = convert_deepvio({k: x.numpy() for k, x in sd.items()}, mt,
                        rnn_num_layers=jc.model.rnn_num_layers,
                        conv_out_hw=trunk_out_hw(jc.model.img_h, jc.model.img_w))
    _, imu, ts = batch()
    fv = np.random.default_rng(1).standard_normal((2, 2, jc.model.v_f_len)).astype(np.float32)
    model = JaxDeepVIO(jc.model, jc.solver, jc.cde_solver_cfg)

    def loss(params, f):
        (poses, _), _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, f,
                                    imu, ts, train=True, method=JaxDeepVIO.pose_from_visual,
                                    mutable=["batch_stats"])
        return jnp.sum(poses ** 2)

    g_params, g_fv = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(fv))
    grads = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, g_params),
                                "batch_stats": v["batch_stats"]}, port_config(jc).model)
    return mt, jc, v, (fv, np.asarray(imu), np.asarray(ts)), grads, np.asarray(g_fv)


def port_grads(model, inputs):
    fv = torch.tensor(inputs[0], requires_grad=True)
    poses = model.pose_from_visual(fv, *map(torch.tensor, inputs[1:]),
                                   generator=torch.Generator().manual_seed(0))[0]
    (poses ** 2).sum().backward()
    return {k: p.grad for k, p in model.named_parameters()}, fv.grad


def assert_close(got, want, name, floor):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=floor * float(np.abs(want).max()), err_msg=name)


def test_adjoint_gradients_match_jax(reference, monkeypatch):
    """Every pose-core and inertial-encoder gradient and the visual
    features' gradient of the port's adjoint step against JAX's; the
    adjoint (not the bounded solve) ran."""
    mt, jc, v, inputs, want, want_fv = reference
    model = port_model(jc, v)
    adjoint = []
    solve = odeint.solve_ivp_adjoint

    def counted(*a, **k):
        adjoint.append(1)
        return solve(*a, **k)

    def bounded(*a, **k):
        raise AssertionError("the bounded solve ran under --adjoint")

    for module in (pose_odernn, interpolation):
        monkeypatch.setattr(module, "solve_ivp_adjoint", counted)
    for module in (pose_odernn, odeint):
        monkeypatch.setattr(module, "solve_ivp_batched_dt", bounded)
    grads, g_fv = port_grads(model, inputs)
    assert len(adjoint) == 2  # one solve per frame interval / segment
    trained = [k for k in grads if k.startswith(("Pose_net.", "Inertial_net."))]
    assert any(k.startswith(FIELD[mt]) for k in trained)
    # a gradient that is rounding noise (the conv biases before a
    # BatchNorm: true gradient 0) is not compared, as compare_state does
    top = max(float(want[k].abs().max()) for k in trained)
    noise = {k for k in trained if float(want[k].abs().max()) <= 1e-5 * top}
    assert noise <= {k for k in trained if "conv" in k and k.endswith(".bias")}
    for k in set(trained) - noise:
        assert_close(grads[k], want[k].numpy(), k, FLOOR[mt])
    assert_close(g_fv, want_fv, "fv", FLOOR[mt])
    assert float(g_fv.abs().max()) > 0



@pytest.mark.parametrize("model_type", ["ode-rnn", "cde"])
def test_adjoint_gradients_match_bounded(model_type):
    """The port's own adjoint against its bounded gradients through the
    whole model (trunk dropout from one generator seed in both), on the
    pose core's field, at ``tests/test_adjoint_models.py``'s tolerance
    (rtol 5e-2, atol 5e-3: the adjoint integrates the backward ODE, the
    bounded solve differentiates its steps); the encoders get gradients
    through the adjoint."""
    img, imu, ts = (torch.from_numpy(np.asarray(x)) for x in batch())
    grads = {}
    for adjoint in (False, True):
        jc = tiny(model_type, adjoint)
        model = create_model(port_config(jc), seed=0, device="cpu", train=True)
        poses = model(img, imu, ts, generator=torch.Generator().manual_seed(1))[0]
        (poses ** 2).sum().backward()
        grads[adjoint] = {k: p.grad for k, p in model.named_parameters()}
    field = [k for k in grads[True] if k.startswith(FIELD[model_type])]
    assert field
    for k in field:
        np.testing.assert_allclose(grads[True][k].numpy(), grads[False][k].numpy(),
                                   rtol=5e-2, atol=5e-3, err_msg=k)
    enc = sum(float((g ** 2).sum()) for k, g in grads[True].items() if k.startswith("Image_net."))
    assert enc > 0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("solver_modes_cli")
    root = make_kitti_tree(base / "kitti", seqs=("05", "07"), n_frames=24, img_hw=(32, 64),
                           speed_scale=50.0)
    return base, root


CLI_FLAGS = ["--img_w", "64", "--img_h", "32", "--seq_len", "4", "--v_f_len", "16",
             "--i_f_len", "8", "--ode_hidden_dim", "12", "--rnn_num_layers", "2",
             "--cde_hidden_dim", "6", "--cde_fn_num_layers", "2", "--compute_dtype", "float32",
             "--batch_size", "4", "--train_seq", "05", "--val_seq", "07",
             "--epochs_warmup", "1", "--epochs_joint", "0", "--epochs_fine", "0",
             "--workers", "0", "--freeze_encoder", "--device", "cpu"]


@pytest.mark.parametrize("mode", [["--adjoint"],
                                  ["--model_type", "cde", "--ode_fixed_step",
                                   "--cde_solver", "implicit_adams"]])
def test_cli_train_solver_modes(tree, mode, monkeypatch):
    """One ``cli.train`` epoch with evaluation: ode-rnn with ``--adjoint``
    (every train step's solves through the adjoint, the evaluation through
    the inference solve), and cde with ``--ode_fixed_step --cde_solver
    implicit_adams`` (train and evaluation through the Adams solve, no
    adaptive step); losses and t_rel finite."""
    base, root = tree
    calls = {"adjoint": 0, "adams": 0, "adaptive": 0}
    adj, adams, core = odeint.solve_ivp_adjoint, odeint._solve_fixed_adams, odeint._solve

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pose_odernn, "solve_ivp_adjoint", count("adjoint", adj))
    monkeypatch.setattr(odeint, "_solve_fixed_adams", count("adams", adams))
    monkeypatch.setattr(odeint, "_solve", count("adaptive", core))
    flags = ["--data_dir", str(root), "--save_dir", str(base / "results"), *CLI_FLAGS, *mode]
    cfg = config_from_args(build_parser().parse_args(flags))
    timing = {}
    train_main(["--experiment_name", "_".join(m.strip("-") for m in mode), *flags],
               timing=timing)
    (epoch,) = timing["epochs"]
    assert np.isfinite(epoch["loss"]) and np.isfinite(epoch["t_rel"])
    steps = len(epoch["steps"])
    assert steps > 0 and all(np.isfinite(s["loss"]) for s in epoch["steps"])
    if cfg.model.adjoint:
        assert cfg.solver.unroll_mode == "adjoint" and calls["adams"] == 0
        assert calls["adjoint"] == steps * (cfg.model.seq_len - 1)
        assert calls["adaptive"] > 0  # the evaluation's inference solves
    else:
        assert (cfg.solver.adaptive, cfg.cde_solver_cfg.method) == (False, "implicit_adams")
        assert calls["adaptive"] == calls["adjoint"] == 0 and calls["adams"] > 0


@pytest.mark.parametrize("mode", ["adjoint", "fixed_step"])
def test_carried_and_streaming_steps_take_the_mode(mode, monkeypatch):
    """The carried step and the TBPTT streaming step (cold, then from the
    carry) train ode-rnn through the adjoint under ``--adjoint`` and
    through the fixed-step solve under ``--ode_fixed_step``: finite losses,
    and every frame interval of every segment through that solve."""
    from ode_vio_tpu_torch.training.loop import (create_train_state, make_streaming_train_step,
                                                 make_train_step)

    flags = [*CLI_FLAGS, "--seq_len", "5", "--carry_split", "2",
             "--adjoint" if mode == "adjoint" else "--ode_fixed_step"]
    cfg = config_from_args(build_parser().parse_args(flags))
    calls = []
    name, fn = (("solve_ivp_adjoint", pose_odernn.solve_ivp_adjoint) if mode == "adjoint"
                else ("_solve_fixed", odeint._solve_fixed))
    monkeypatch.setattr(pose_odernn if mode == "adjoint" else odeint, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    rng = np.random.default_rng(0)
    batch = (rng.random((4, 5, 32, 64, 3), np.float32) - 0.5,
             rng.standard_normal((4, 41, 6)).astype(np.float32),
             (0.1 * rng.standard_normal((4, 4, 6))).astype(np.float32),
             np.cumsum(rng.uniform(0.08, 0.13, (4, 5)), 1).astype(np.float32))
    state = create_train_state(cfg, create_model(cfg, seed=0, device="cpu", train=True),
                               device="cpu")
    state, m = make_train_step(cfg, carry=True, device="cpu")(state, *batch)
    assert np.isfinite(float(m["loss"])) and len(calls) == 4  # 2 + 2 intervals
    step = make_streaming_train_step(cfg, device="cpu")
    hc = None
    for _ in range(2):
        state, m, hc = step(state, *batch, hc)
        assert np.isfinite(float(m["loss"])) and not hc.requires_grad
    assert len(calls) == 4 + 2 * 4
