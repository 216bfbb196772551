"""The port's single-card edges on the CPU against the JAX package:
``cli.export`` (the key set and values of JAX's ``export_deepvio`` for
all six pose cores, and JAX's ``convert_deepvio`` running the port's
export), ``cli.parity`` with its reference-protocol tester (the report
against JAX's), and ``utils/profiling.py`` (FLOPs, ``--profile_dir``,
``--debug_nans`` against ``jax.debug_nans``).

Tolerances: the export is exact (float32 tensors copied); JAX running the
port's export within 1e-5 of the port's poses (float32, euler fixed
steps: the same arithmetic but for the order of sums); the parity
reports' reference side within 1e-6 relative (the same torch code on the
same windows), our side within 1e-3 relative on t_rel and r_rel, as
tests/test_torch_port_cli.py holds ``cli.test``'s summary means."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_vio_tpu.cli.parity import main as jax_parity_main
from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.models.convert import convert_deepvio, export_deepvio, trunk_out_hw
from ode_vio_tpu.models.deepvio import create_model as jax_create_model
from ode_vio_tpu_torch.cli import train as cli_train
from ode_vio_tpu_torch.cli.export import main as export_main
from ode_vio_tpu_torch.cli.flags import build_parser, config_from_args
from ode_vio_tpu_torch.cli.parity import main as parity_main
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import analyse_flops, create_model
from ode_vio_tpu_torch.reference.torch_tester import build_reference_model
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
from ode_vio_tpu_torch.training.loop import create_train_state
from ode_vio_tpu_torch.utils import profiling

from torch_port_helpers import TINY, batch, configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CORES = {"ode-rnn": {}, "rnn": {}, "cde": dict(cde_hidden_dim=8), "rde": dict(cde_hidden_dim=8),
         "cfc": dict(rnn_hidden_dim=8), "ltc": dict(rnn_hidden_dim=8)}


def model_flags(fields: dict) -> list:
    return [a for k, v in fields.items() for a in (f"--{k}", str(v))]


def save_checkpoint(model, cfg, directory) -> None:
    """``model`` as epoch 0 of a checkpoints directory; its mode is kept
    (a train state puts its model in train mode)."""
    mode = model.training
    state = create_train_state(cfg, model, device="cpu")
    CheckpointManager(directory).save("epoch_000", state, {"epoch": 0})
    model.train(mode)


# --- cli.export --------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    """The tiny ode-rnn in JAX (seeded init, non-trivial BatchNorm
    statistics) and in the port on the bridged weights."""
    jc, tc = configs()
    jm, variables = jax_model(jc)
    model = create_model(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables, tc.model), strict=True)
    return jm, variables, model


def exported(model, cfg, fields, tmp_path, capsys) -> dict:
    """``model`` through a checkpoints directory and ``cli.export`` to .npz
    and .pth: both files' arrays, which must agree, and JAX's summary
    line."""
    save_checkpoint(model, cfg, tmp_path / "ckpt")
    argv = [*model_flags(fields), "--device", "cpu", "--pretrain", str(tmp_path / "ckpt")]
    sd = export_main([*argv, "--out", str(tmp_path / "m.npz")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"exported {len(sd)} tensors ({fields['model_type']}) from "
                    f"{tmp_path / 'ckpt' / 'epoch_000'} -> {tmp_path / 'm.npz'}")
    export_main([*argv, "--out", str(tmp_path / "m.pth")])
    with np.load(tmp_path / "m.npz") as z:
        npz = {k: z[k] for k in z.files}
    pth = torch.load(tmp_path / "m.pth", weights_only=True)
    assert pth.keys() == npz.keys()
    for k, v in npz.items():
        assert v.dtype == np.float32 and v.flags.c_contiguous
        assert pth[k].dtype == torch.float32 and pth[k].is_contiguous()
        np.testing.assert_array_equal(pth[k].numpy(), v, err_msg=k)
    return npz


def jax_variables(jc, seed: int):
    """Variables of the JAX package's model for ``jc``: the tree and shapes
    of its init (``jax.eval_shape``, nothing compiled) filled with seeded
    values, BatchNorm variances positive."""
    model, m = jax_create_model(jc), jc.model
    S = m.seq_len
    rngs = {k: jax.random.PRNGKey(0) for k in ("params", "dropout", "gumbel")}
    shapes = jax.eval_shape(lambda: model.init(
        rngs, jnp.zeros((1, S, m.img_h, m.img_w, 3)), jnp.zeros((1, 10 * (S - 1) + 1, 6)),
        jnp.arange(S, dtype=jnp.float32)[None] * 0.1, train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("model_type", sorted(CORES))
def test_export_matches_jax_export(model_type, tmp_path, capsys):
    """Seeded JAX variables of each pose core, bridged into a port
    checkpoints directory and through ``cli.export``: JAX's
    ``export_deepvio`` of the same variables, its key set (no
    ``num_batches_tracked``) and its float32 values, bit for bit."""
    fields = dict(TINY, model_type=model_type, **CORES[model_type])
    jc, tc = configs(**fields)
    variables = jax_variables(jc, seed=len(model_type))
    model = create_model(tc, device="cpu")
    model.load_state_dict(from_jax_variables(variables, tc.model), strict=True)
    got = exported(model, tc, fields, tmp_path, capsys)
    want = export_deepvio(variables, model_type, trunk_out_hw(TINY["img_h"], TINY["img_w"]))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


def test_jax_runs_the_port_export(tmp_path):
    """The port's own seeded init, its BatchNorm statistics moved by two
    train-mode forwards, exported to .npz: JAX's ``convert_deepvio`` of the
    file gives poses within 1e-5 of the port's (ode-rnn, float32, euler
    fixed steps)."""
    jc, tc = configs()
    import dataclasses

    solver = dict(method="euler", adaptive=False)
    jc = dataclasses.replace(jc, solver=dataclasses.replace(jc.solver, **solver))
    tc = dataclasses.replace(tc, solver=dataclasses.replace(tc.solver, **solver))
    model = create_model(tc, seed=3, device="cpu", train=True)
    img, imu, ts = (torch.from_numpy(a) for a in batch([1, 2]))
    with torch.no_grad():
        for _ in range(2):
            model.encode(img, imu, torch.Generator().manual_seed(0))
    model.eval()
    save_checkpoint(model, tc, tmp_path / "ckpt")
    export_main([*model_flags(TINY), "--ode_solver", "euler", "--ode_fixed_step",
                 "--device", "cpu", "--pretrain", str(tmp_path / "ckpt"),
                 "--out", str(tmp_path / "m.npz")])
    with np.load(tmp_path / "m.npz") as z:
        sd = {k: z[k] for k in z.files}
    variables = convert_deepvio(sd, "ode-rnn", rnn_num_layers=TINY["rnn_num_layers"],
                                conv_out_hw=trunk_out_hw(TINY["img_h"], TINY["img_w"]))
    want, _ = jax_create_model(jc).apply(variables, *(jnp.asarray(a.numpy()) for a in (img, imu, ts)),
                       train=False, rngs={"gumbel": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = model(img, imu, ts)[0]
    assert float(got.abs().max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# --- cli.parity --------------------------------------------------------------

PARITY_SEQ = "07"
# tests/test_parity_cli.py's flags; 26 frames (5 windows of seq_len 6, no
# ragged tail) at 5 m a frame, over 100 m, where that test takes 251 at 0.8 m
PARITY_FLAGS = [
    "--val_seq", PARITY_SEQ, "--img_w", "128", "--img_h", "64", "--seq_len", "6",
    "--v_f_len", "32", "--i_f_len", "16", "--ode_hidden_dim", "24",
    "--ode_fn_num_layers", "2", "--ode_activation_fn", "tanh", "--ode_rnn_type", "rnn",
    "--rnn_num_layers", "2", "--fuse_method", "soft", "--compute_dtype", "float32",
    "--ode_solver", "euler", "--ode_fixed_step", "--run_times", "1", "--workers", "0",
]


@pytest.fixture(scope="module")
def parity_setup(tmp_path_factory):
    """A synthetic tree and a reference-replica checkpoint with moved
    BatchNorm statistics, as tests/test_parity_cli.py makes them."""
    base = tmp_path_factory.mktemp("parity")
    root = make_kitti_tree(base / "kitti", seqs=(PARITY_SEQ,), n_frames=26,
                           img_hw=(64, 128), speed_scale=50.0)
    common = ["--data_dir", str(root), "--save_dir", str(base / "results"), *PARITY_FLAGS]
    cfg = config_from_args(build_parser().parse_args(common))
    torch.manual_seed(11)
    t_model = build_reference_model(cfg, "cpu")
    with torch.no_grad():
        t_model.train()
        t_model.Image_net(torch.randn(2, 3, 3, 64, 128))
        t_model.Inertial_net(torch.randn(2, 10 * 2 + 1, 6))
        t_model.eval()
    ckpt = base / "replica.pth"
    torch.save(t_model.state_dict(), ckpt)
    return base, common, ckpt


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parity_report_matches_jax(parity_setup, capsys):
    base, common, ckpt = parity_setup
    args = [*common, "--ref_ckpt", str(ckpt), "--torch_protocol", "--max_delta_pct", "2.0"]
    assert jax_parity_main(args) == 0
    want = last_json(capsys)
    assert parity_main([*args, "--device", "cpu"]) == 0
    got = last_json(capsys)
    assert got.keys() == want.keys()
    for key in ("checkpoint", "model_type", "eval_data_dropout", "run_times", "ref_source"):
        assert got[key] == want[key]
    assert got["ref_source"] == "torch_protocol"
    (g,), (w,) = got["rows"], want["rows"]
    assert g["seq"] == w["seq"] == PARITY_SEQ
    for k in ("t_rel", "r_rel", "t_rmse", "r_rmse"):
        np.testing.assert_allclose(g["ref"][k], w["ref"][k], rtol=1e-6)
    for k in ("t_rel", "r_rel"):
        assert np.isfinite(g["ours"][k])
        np.testing.assert_allclose(g["ours"][k], w["ours"][k], rtol=1e-3)
    assert got["worst_delta_pct"] <= 2.0


def test_parity_recorded_metrics_gate(parity_setup, tmp_path, capsys):
    """``--ref_metrics``: a recorded reference 10 % off our t_rel fails
    ``--max_delta_pct 5`` with exit code 1."""
    base, common, ckpt = parity_setup
    assert parity_main([*common, "--device", "cpu", "--ref_ckpt", str(ckpt)]) == 0
    ours = last_json(capsys)["rows"][0]["ours"]
    recorded = tmp_path / "metrics.json"
    recorded.write_text(json.dumps({PARITY_SEQ: {"t_rel": ours["t_rel"] / 1.1,
                                                 "r_rel": ours["r_rel"]}}))
    rc = parity_main([*common, "--device", "cpu", "--ref_ckpt", str(ckpt),
                      "--ref_metrics", str(recorded), "--max_delta_pct", "5"])
    report = last_json(capsys)
    assert rc == 1 and report["ref_source"] == "recorded"
    np.testing.assert_allclose(report["worst_delta_pct"], 10.0, rtol=1e-9)


def test_parity_rejects_mismatched_flags(parity_setup):
    base, common, ckpt = parity_setup
    bad = list(common)
    bad[bad.index("--rnn_num_layers") + 1] = "3"
    with pytest.raises(SystemExit, match="does not match the model flags"):
        parity_main([*bad, "--device", "cpu", "--ref_ckpt", str(ckpt)])


# --- utils/profiling.py --------------------------------------------------------

def test_flops_of_a_matmul():
    a = torch.ones(64, 64)
    out = profiling.flops_analysis(lambda x, y: x @ y, a, a)
    assert out["flops"] == 2 * 64 ** 3 and out["by_op"] == {"aten.mm": 2 * 64 ** 3}


def test_analyse_flops_counts_the_trunk():
    """JAX's test_misc_api check: the conv trunk alone is hundreds of
    MFLOPs at this size."""
    from ode_vio_tpu_torch.config import Config, ModelConfig

    cfg = Config(model=ModelConfig(model_type="rnn", img_w=64, img_h=32, seq_len=3,
                                   v_f_len=16, i_f_len=8, rnn_num_layers=1,
                                   compute_dtype="float32"))
    out = analyse_flops(cfg, device="cpu")
    assert out["flops"] > 1e7 and out["by_op"]["aten.convolution"] > 1e7


def test_timer_annotate_memory_stats():
    """A span times its block only while a profiler collects, and the CPU
    has no allocator statistics."""
    profiling.clear()
    with profiling.span("ode_vio.test.off"):
        torch.ones(4).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("ode_vio.test.on"):
            torch.ones(4).sum()
    (s,) = profiling.record()["spans"]
    profiling.clear()
    assert s.name == "ode_vio.test.on" and s.parent is None and s.t1 >= s.t0
    assert profiling.device_memory_stats("cpu") == {}


def trace_events(directory):
    (path,) = list(directory.glob("trace_*.json"))
    return json.loads(path.read_text())["traceEvents"]


def test_profile_dir_traces_steps_of_the_first_epoch(tmp_path):
    """``cli.train --profile_dir`` on a CPU epoch of 5 or more steps: one
    trace of steps 1-4 (step 0 the profiler's warm-up, left out) holding
    the trunk's convolutions."""
    root = make_kitti_tree(tmp_path / "kitti", seqs=("05",), n_frames=24, img_hw=(32, 64),
                           speed_scale=50.0)
    timing = {}
    cli_train.main([
        "--device", "cpu", "--data_dir", str(root), "--save_dir", str(tmp_path / "results"),
        "--img_h", "32", "--img_w", "64", "--seq_len", "4", "--v_f_len", "32",
        "--i_f_len", "16", "--ode_hidden_dim", "16", "--compute_dtype", "float32",
        "--train_seq", "05", "--val_seq", "05", "--batch_size", "4", "--workers", "0",
        "--epochs_warmup", "1", "--epochs_joint", "0", "--epochs_fine", "0",
        "--profile_dir", str(tmp_path / "prof")], timing)
    assert len(timing["epochs"][0]["steps"]) >= 5
    names = {e.get("name") for e in trace_events(tmp_path / "prof")}
    assert "aten::convolution" in names
    assert {n for n in names if str(n).startswith("ProfilerStep#")} == {
        f"ProfilerStep#{i}" for i in range(1, 5)}


def test_profile_dir_closes_a_short_epoch(tmp_path):
    """An epoch of 3 steps: the trace begun at step 1 is written at its end;
    a later epoch is not traced."""
    calls = []

    def step(state, *batch):
        calls.append(batch)
        return state, {"loss": torch.tensor(1.0), "solver_incomplete": torch.tensor(0)}

    cfg = configs()[1]
    import logging

    for epoch in (0, 1):
        cli_train.train_epoch(cfg, [(torch.ones(2),)] * 3, step, None, logging.getLogger(),
                              epoch, profile_dir=tmp_path / "prof")
    assert len(calls) == 6
    assert trace_events(tmp_path / "prof")


# --- --debug_nans ---------------------------------------------------------------

@pytest.mark.parametrize("poison", [False, True])
def test_debug_nans_raises_where_jax_does(tiny_models, poison):
    """A NaN in one IMU sample: the port's forward raises FloatingPointError
    under the trap where JAX's raises under ``jax.debug_nans(True)``; a
    clean window raises in neither; without the trap neither raises. The
    trap is off again afterwards."""
    jm, variables, model = tiny_models
    img, imu, ts = batch([1, 2])
    if poison:
        imu[0, 3, 2] = np.nan
    for on in (False, True):
        raised = {}
        try:
            with jax.debug_nans(on):
                jax.block_until_ready(jm.apply(
                    variables, *(jnp.asarray(a) for a in (img, imu, ts)), train=False,
                    rngs={"gumbel": jax.random.PRNGKey(0)}))
        except FloatingPointError:
            raised["jax"] = True
        try:
            with profiling.debug_nans(on), torch.no_grad():
                model(*(torch.from_numpy(a) for a in (img, imu, ts)))
        except FloatingPointError as e:
            raised["port"] = True
            assert "InertialEncoder" in str(e)
        assert raised == ({"jax": True, "port": True} if on and poison else {})
    assert profiling._nan_hook is None and not torch.is_anomaly_enabled()


def test_debug_nans_flag_turns_the_trap_on(tiny_models):
    """``--debug_nans`` in the flags switches the trap on for the process,
    as JAX's flag sets ``jax_debug_nans``."""
    _, _, model = tiny_models
    img, imu, ts = batch([1])
    imu[0, 0, 0] = np.nan
    try:
        config_from_args(build_parser().parse_args(["--debug_nans"]))
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError), torch.no_grad():
            model(*(torch.from_numpy(a) for a in (img, imu, ts)))
    finally:
        profiling.set_debug_nans(False)
    assert not torch.is_anomaly_enabled()
