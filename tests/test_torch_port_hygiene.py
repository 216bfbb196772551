"""The port stands alone and never falls back: no module of
ode_vio_tpu_torch (nor chip_smoke.py) imports JAX or the JAX package, and
its entry points default to CUDA, so on a machine without a card they
raise instead of quietly running on the CPU."""

import ast
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
    bad = {str(f.relative_to(ROOT)): r for f in files for r in imported_roots(f)
           if r in FORBIDDEN}
    assert not bad, f"forbidden imports: {bad}"


def test_entry_points_default_to_cuda_and_do_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from ode_vio_tpu_torch.config import Config, ModelConfig
    from ode_vio_tpu_torch.models.deepvio import create_model
    from ode_vio_tpu_torch.serving import StreamingEngine
    from ode_vio_tpu_torch.training.loop import (create_train_state, make_infer_fn,
                                                 make_train_step)

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
        create_train_state(cfg, model)


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
