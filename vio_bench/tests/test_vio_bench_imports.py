"""Nothing under vio_bench/ imports JAX or the JAX package, and the plain
reference imports nothing of the measured program. Modules are compared by
their whole top-level name (the part before the first dot): the port's
name begins with the JAX package's."""

import ast

import pytest

from vio_bench.harness import BENCH_DIR

JAX_SIDE = {"jax", "jaxlib", "flax", "ode_vio_tpu"}
PROGRAM = "ode_vio_tpu_torch"
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_sources_are_found():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH_DIR).as_posix())
def test_no_jax_side_import(path):
    assert not set(top_level_imports(path)) & JAX_SIDE


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(top_level_imports(path))


def test_top_level_names_are_compared_whole():
    assert "ode_vio_tpu_torch".split(".")[0] not in JAX_SIDE
    assert "ode_vio_tpu.models".split(".")[0] in JAX_SIDE
