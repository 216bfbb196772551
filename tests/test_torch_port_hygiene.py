"""The port stands alone and never falls back: no module of
ode_vio_tpu_torch (nor chip_smoke.py) imports JAX or the JAX package or
names a path under the JAX package's directories, and its entry points
(the command lines too) default to CUDA, so on a machine without a card
they raise instead of quietly running on the CPU."""

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ode_vio_tpu")


def port_sources():
    pkg = ROOT / "ode_vio_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.relative_to(pkg).parts) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    pkg = ROOT / "ode_vio_tpu_torch"
    assert {pkg / "ops" / "liquid.py", pkg / "models" / "pose_rnn.py",
            pkg / "models" / "pose_ncp.py", pkg / "cli" / "export.py", pkg / "cli" / "parity.py",
            pkg / "reference" / "torch_tester.py", pkg / "utils" / "profiling.py"} <= set(files)
    bad = {str(f.relative_to(ROOT)): r for f in files for r in imported_roots(f)
           if r in FORBIDDEN}
    assert not bad, f"forbidden imports: {bad}"


# a string that names a file or directory under native/ or ode_vio_tpu/;
# "file.py:line" references (chip_smoke.py's kernel table) name no path
# that the code opens
JAX_PATH = re.compile(r"^(\.?/)?(native|ode_vio_tpu)(/|$)")
LINE_REF = re.compile(r"\.py:\d+$")


def code_strings(path: Path):
    """The string constants of ``path`` outside docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            yield node.value


def test_port_names_no_path_of_the_jax_package():
    """The port keeps its own copies (the decoder's source is
    ode_vio_tpu_torch/csrc/vioio.cpp): no string in its code is a path
    under native/ or ode_vio_tpu/, and the decoder builds from its own
    source into its own build directory."""
    from ode_vio_tpu_torch.data import native_loader

    bad = {str(f.relative_to(ROOT)): s for f in port_sources() for s in code_strings(f)
           if JAX_PATH.match(s) and not LINE_REF.search(s)}
    assert not bad, f"paths under the JAX package: {bad}"
    pkg = ROOT / "ode_vio_tpu_torch"
    assert native_loader._SRC == pkg / "csrc" / "vioio.cpp"
    assert native_loader.library_path().parent == pkg / "_build"


def test_entry_points_default_to_cuda_and_do_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.serving import StreamingEngine
    from ode_vio_tpu_torch.training.loop import (create_train_state, make_infer_fn,
                                                 make_streaming_train_step, make_train_step)

    cfg = Config(model=ModelConfig(img_h=64, img_w=128, seq_len=3, v_f_len=32,
                                   i_f_len=16, ode_hidden_dim=16,
                                   compute_dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg)
    model = create_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(model, max_sessions=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_infer_fn(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, carry=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_streaming_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(cfg, model)


def test_entry_py_and_experiments_default_to_cuda(tmp_path):
    """entry(), dryrun_multichip, the learning checks and the irregularity
    experiment raise without a card unless asked for the CPU; none starts
    a rank or writes a tree first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ode_vio_tpu_torch.entry import dryrun_multichip, entry
    from ode_vio_tpu_torch.experiments import convergence, irregularity

    for call in (entry, lambda: dryrun_multichip(4),
                 lambda: convergence.learn("plain", tmp_path),
                 lambda: irregularity.main(["--tree", str(tmp_path / "tree")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "tree").exists()


def test_kernel_wrapper_raises_off_cuda_and_cpu():
    from ode_vio_tpu_torch.ops.cuda_kernels import fused_ode_solve

    y = torch.zeros(2, 4, device="meta")
    t = torch.zeros(2, device="meta")
    layers = [(torch.zeros(4, 4, device="meta"), torch.zeros(4, device="meta"))]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fused_ode_solve(layers, y, t, t)


def test_k3_wrapper_raises_off_cuda_and_cpu():
    from ode_vio_tpu_torch.ops.cuda_kernels import fused_dropout

    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fused_dropout(torch.zeros(8, device="meta"), 1, 0.5)


def test_k2_wrapper_raises_off_cuda_and_cpu():
    from ode_vio_tpu_torch.ops.cuda_kernels import fused_cde_solve

    z = torch.zeros(2, 4, device="meta")
    ts = torch.zeros(2, 3, device="meta")
    b = torch.zeros(2, 2, 5, device="meta")
    layers = [(torch.zeros(4, 4, device="meta"), torch.zeros(4, device="meta")),
              (torch.zeros(20, 4, device="meta"), torch.zeros(20, device="meta"))]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fused_cde_solve(layers, z, ts, b, None, None, ts)


@pytest.mark.parametrize("model_type", ["cde", "rde"])
def test_cde_and_rde_models_default_to_cuda(model_type):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.serving import StreamingEngine

    cfg = Config(model=ModelConfig(model_type=model_type, img_h=64, img_w=128, seq_len=3,
                                   v_f_len=32, i_f_len=16, cde_hidden_dim=8,
                                   compute_dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg)
    model = create_model(cfg, device="cpu")
    assert model.cde_solver == cfg.cde_solver_cfg
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(model, max_sessions=2)


@pytest.mark.parametrize("model_type", ["rnn", "cfc", "ltc"])
def test_rnn_and_liquid_models_default_to_cuda(model_type):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.serving import StreamingEngine

    cfg = Config(model=ModelConfig(model_type=model_type, img_h=64, img_w=128, seq_len=3,
                                   v_f_len=32, i_f_len=16, rnn_hidden_dim=8,
                                   compute_dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg)
    model = create_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(model, max_sessions=2)


# each command line's required flags; no file is read before the device
REQUIRED = {"export": ["--pretrain", ".", "--out", "model.npz"],
            "parity": ["--ref_ckpt", "model.pth"]}


@pytest.mark.parametrize("command", ["test", "serve", "train", "export", "parity"])
def test_command_lines_default_to_cuda(command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    import importlib

    main = importlib.import_module(f"ode_vio_tpu_torch.cli.{command}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data_dir", "synthetic", "--val_seq", "05", *REQUIRED.get(command, [])])


def test_reference_tester_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import analyse_flops
    from ode_vio_tpu_torch.reference.torch_tester import build_reference_model

    cfg = Config(model=ModelConfig(img_h=64, img_w=128, seq_len=3, v_f_len=32,
                                   i_f_len=16, ode_hidden_dim=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_reference_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyse_flops(cfg)
