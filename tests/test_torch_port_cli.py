"""The port's command lines on the CPU: ``cli.test --device cpu`` against
the JAX package's ``cli.test``, both given the same reference-layout
``.npz`` (JAX's ``export_deepvio``), summary means within rtol 1e-3;
``cli.serve`` single- and multi-session with the JAX package's report
keys; the plot command line; and the readable exits: a checkpoint of
another ``--model_type``, a JAX checkpoint directory, and the mesh flags
that ask for more than there is (in ``cli.train`` too)."""

import re
import sys

import numpy as np
import pytest
import torch

from ode_vio_tpu.cli.test import main as jax_test_main
from ode_vio_tpu.data.synthetic import make_kitti_tree
from ode_vio_tpu.models.convert import export_deepvio, trunk_out_hw
from ode_vio_tpu_torch.cli.plot import main as plot_main
from ode_vio_tpu_torch.cli.serve import main as serve_main
from ode_vio_tpu_torch.cli.test import main as cli_test_main
from ode_vio_tpu_torch.cli.train import main as train_main
from ode_vio_tpu_torch.utils import geometry as geo

from torch_port_helpers import configs, jax_model, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEQ_LEN, IMG_H, IMG_W = 4, 32, 64
MODEL = dict(seq_len=SEQ_LEN, img_h=IMG_H, img_w=IMG_W)
MODEL_FLAGS = [
    "--img_w", str(IMG_W), "--img_h", str(IMG_H), "--seq_len", str(SEQ_LEN),
    "--v_f_len", "64", "--i_f_len", "32", "--ode_hidden_dim", "32",
    "--rnn_num_layers", "2", "--ode_activation_fn", "softplus",
    "--ode_fn_num_layers", "2", "--fuse_method", "soft", "--compute_dtype", "float32",
]

# the keys of the JAX package's serve reports (ode_vio_tpu/cli/serve.py);
# the single-session report adds solver_incomplete only when it is not 0
SINGLE_KEYS = {"seq", "windows", "frames", "latency_ms_p50", "latency_ms_p90",
               "latency_ms_p99", "frames_per_sec", "t_rmse", "trajectory"}
MULTI_KEYS = {"sessions", "steps", "frames", "latency_ms_p50", "latency_ms_p90",
              "latency_ms_p99", "frames_per_sec", "t_rmse", "solver_incomplete"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two 24-frame sequences at ~5 m per frame (over 100 m: t_rel and
    r_rel finite) and the tiny model's weights as a reference-layout .npz."""
    base = tmp_path_factory.mktemp("cli")
    root = make_kitti_tree(base / "kitti", seqs=("05", "07"), n_frames=24,
                           img_hw=(IMG_H, IMG_W), speed_scale=50.0)
    jc, _ = configs(**MODEL)
    _, variables = jax_model(jc)
    npz = base / "model.npz"
    np.savez(npz, **export_deepvio(variables, "ode-rnn", trunk_out_hw(IMG_H, IMG_W)))
    common = ["--data_dir", str(root), "--save_dir", str(base / "results"),
              "--pretrain", str(npz), *MODEL_FLAGS]
    return base, root, npz, common


def summary_means(path):
    """{(seq, metric): mean} from a summary.txt."""
    out = {}
    for line in path.read_text().splitlines():
        seq, stats = line.split(": ", 1)
        for metric, mean in re.findall(r"(\w+): (\S+) \+-", stats):
            out[(seq, metric)] = float(mean)
    return out


def test_cli_test_matches_jax(setup):
    base, _, _, common = setup
    args = [*common, "--val_seq", "05", "07", "--run_times", "2", "--batch_runs",
            "--eval_data_dropout", "0.3"]
    jax_test_main(["--experiment_name", "jax", *args])
    cli_test_main(["--experiment_name", "port", "--device", "cpu", *args])
    ref = summary_means(base / "results/jax_test/summary.txt")
    ours = summary_means(base / "results/port_test/summary.txt")
    assert ours.keys() == ref.keys() and len(ref) == 8
    for key, mean in ref.items():
        assert np.isfinite(mean), key
        assert ours[key] == pytest.approx(mean, rel=1e-3), key
    poses = base / "results/port_test/poses"
    for seq in ("05", "07"):
        est, _ = geo.read_pose_file(poses / f"{seq}_pred.txt")
        gt, _ = geo.read_pose_file(poses / f"{seq}_gt.txt")
        assert est.shape == gt.shape and np.isfinite(est).all()
    # the plot command line on the port's dumps
    out = base / "cmp.png"
    plot_main(["--gt", str(poses / "05_gt.txt"), "--pred", f"port={poses / '05_pred.txt'}",
               "--out", str(out)])
    assert out.exists()


def test_cli_test_without_matplotlib(setup, monkeypatch, caplog):
    """No matplotlib: one warning, no plots; summary and dumps written."""
    base, _, _, common = setup
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cli_test_main(["--experiment_name", "noplot", "--device", "cpu", *common,
                   "--val_seq", "05", "--run_times", "2"])
    out = base / "results/noplot_test"
    assert "seq 05" in (out / "summary.txt").read_text()
    assert (out / "poses/05_pred.txt").exists()
    assert not list((out / "graphs").glob("*.png"))
    warnings = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warnings) == 1 and warnings[0].levelname == "WARNING"


@pytest.mark.parametrize("seqs", [["05"], ["05", "07"]])
def test_cli_serve_reports(setup, seqs):
    base, _, _, common = setup
    name = f"serve{len(seqs)}"
    timing = {}
    report = serve_main(["--experiment_name", name, "--device", "cpu", *common,
                         "--val_seq", *seqs], timing=timing)
    keys = set(report)
    if len(seqs) == 1:
        assert keys - {"solver_incomplete"} == SINGLE_KEYS
        assert report["windows"] > 0 and report["frames"] == 23
    else:
        assert keys == MULTI_KEYS
        assert report["sessions"] == 2 and report["frames"] == 46
    assert report["latency_ms_p50"] > 0
    assert 0.0 <= timing["decode_wait_s"] <= timing["wall_s"]
    for seq in seqs:
        served, _ = geo.read_pose_file(base / f"results/{name}_serve/poses/{seq}_pred.txt")
        assert served.shape[0] == 24


def test_mismatched_model_type_exits(setup):
    _, _, _, common = setup
    with pytest.raises(SystemExit, match="does not match the model flags"):
        cli_test_main(["--experiment_name", "mismatch", "--device", "cpu", *common,
                       "--model_type", "cde"])


def test_directory_pretrain_exits(setup):
    base, _, _, common = setup
    ckpt = base / "orbax_ckpt"
    ckpt.mkdir(exist_ok=True)
    with pytest.raises(SystemExit, match=r"directory.*cli\.export.*training/checkpoint\.py"):
        cli_test_main(["--experiment_name", "dir", "--device", "cpu", *common,
                       "--pretrain", str(ckpt)])


# the flags the port once refused as unported, each with a value that
# breaks the mesh on a host of CARDS cards: (flags, the command lines, the
# error); --eval_dp splits eval and serving lanes, and cli.train ignores it
CARDS = 2
MESH_ERRORS = {
    "eval_dp": (["--device", "cuda", "--eval_dp", "3"], ("test", "serve"),
                "--eval_dp 3: 3 devices asked for and this host has 2 CUDA cards"),
    "mesh_data": (["--device", "cuda", "--mesh_data", "4"], ("train",),
                  "--mesh_data 4 x --mesh_model 1 needs 4 devices and there are 2"),
    "mesh_model": (["--device", "cuda", "--mesh_model", "3"], ("train",),
                   "--mesh_model 3 does not fit 2 devices"),
    "multihost": (["--device", "cpu", "--multihost"], ("test", "serve", "train"),
                  "--multihost needs the launcher's variables; missing: MASTER_ADDR, "
                  "MASTER_PORT, RANK (or SLURM_PROCID), WORLD_SIZE (or SLURM_NTASKS), "
                  "LOCAL_RANK (or SLURM_LOCALID)"),
}


@pytest.mark.parametrize("name", sorted(MESH_ERRORS))
def test_unported_flag_exits(setup, name, monkeypatch):
    """The mesh flags, once refused as unported, now raise the mesh's own
    errors as SystemExit before any work is done: more cards than the host
    has (it reports CARDS here), a model axis larger than the cards, and
    --multihost without the launcher's variables."""
    _, _, _, common = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: CARDS)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"):
        monkeypatch.delenv(var, raising=False)
    args, commands, error = MESH_ERRORS[name]
    mains = {"test": cli_test_main, "serve": serve_main, "train": train_main}
    for command in commands:
        with pytest.raises(SystemExit, match=f"^{re.escape(error)}$"):
            mains[command](["--experiment_name", "mesh_errors", *common, *args])
