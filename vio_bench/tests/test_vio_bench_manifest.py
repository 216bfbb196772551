"""The manifest (BENCHMARK.json) against the benchmark's contract and the
files the harness finds by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

from vio_bench.harness import BENCH_DIR

ROOT = BENCH_DIR.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["paths"] == ["vio_bench"]
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(TEXT.match(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43,200 s
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_units_and_fields(section):
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if section == "end_to_end" else {"layer", "moves"})
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for e in MANIFEST[section]:
        assert set(e) <= allowed and allowed - {"workloads"} <= set(e), e
        assert UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
        assert set(e.get("workloads", cells)) <= cells
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0 < e["bound"] <= 0.25
        else:
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert TEXT.match(e["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {e["name"]: e for e in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in MANIFEST["workloads"]:
        mine = [e for e in MANIFEST["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layers = [e for e in MANIFEST["per_layer"] if w["name"] in e.get("workloads", [w["name"]])]
        assert layers
        for p in layers:
            moved = e2e[p["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]]), (p["name"], w["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_to_its_files(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert entry["chips"] in (1, 4) and TEXT.match(entry["why"])
    work = json.loads((BENCH_DIR / "workloads" / f"{cell}.json").read_text())
    assert {k: work[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert work["limits"]
    assert any(c["name"] == work["config"] for c in MANIFEST["configs"])
    mix = json.loads((BENCH_DIR / "traffic" / "mixes" / f"{work['traffic']}.json").read_text())
    kind = importlib.import_module(f"vio_bench.traffic.{mix['kind']}")
    assert callable(kind.prepare)
    for p in MANIFEST["per_layer"]:
        if cell in p.get("workloads", [cell]):
            assert (BENCH_DIR / "metrics" / f"{p['name']}.py").exists(), p["name"]
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_file_matches_its_entry(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    assert entry["file"] == f"vio_bench/configs/{config}.json"
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    assert entry["source"].startswith("https://") and TEXT.match(entry["source"])
    assert any(w["config"] == config for w in MANIFEST["workloads"])
    from ode_vio_tpu_torch.config import ModelConfig
    from vio_bench.harness import program_config

    assert isinstance(program_config(data).model, ModelConfig)


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
