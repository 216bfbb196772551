"""One run of one benchmark cell.

``python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Everything about a cell is found by name:

* ``vio_bench/workloads/<cell>.json``: the configuration, the traffic mix,
  the chips, why the cell exists, and the limit of each number its
  correctness check compares;
* ``vio_bench/configs/<config>.json``: the model configuration as it is
  run (the measured program's ``Config`` fields), with its source;
* ``vio_bench/traffic/mixes/<mix>.json``: the mix's parameters and its
  kind, the module ``vio_bench/traffic/<kind>.py`` that generates and
  serves it, times it, and checks what the program returned against the
  plain reference (``vio_bench/reference/``);
* ``vio_bench/metrics/<metric>.py``: one reader per per-layer metric.

``BENCHMARK.json`` at the root of the checkout says which end-to-end and
per-layer metrics a cell reports. A run sets up (``setup_s`` counts from
the process's start to the window's opening), measures for ``--seconds``,
reads the device's peak memory, frees the program's state, checks
correctness, and prints one JSON line: the end-to-end metrics with
``--trace 0``, the per-layer ones, read from a ``torch.profiler`` trace of
the window, with ``--trace 1``. The numbers compared, each beside its
limit, close both standard error and the result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ode_vio_tpu")
PROGRAM = "ode_vio_tpu_torch"


class Failure(Exception):
    """A run that cannot produce a result: exit non-zero, print none."""


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise Failure(f"{path} not found") from None


def load_cell(name: str) -> dict:
    """The cell's workload file with its configuration and mix resolved."""
    cell = _load_json(BENCH_DIR / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_file"] = _load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    cell["mix"] = _load_json(BENCH_DIR / "traffic" / "mixes" / f"{cell['traffic']}.json")
    return cell


def reported(entries: list, cell: str) -> list:
    """The metric entries of ``BENCHMARK.json`` that ``cell`` reports."""
    return [e for e in entries if "workloads" not in e or cell in e["workloads"]]


def load_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        raise Failure(f"no reader for the per-layer metric {name} ({path})")
    spec = importlib.util.spec_from_file_location(f"vio_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def program_config(cfg_file: dict):
    """The program's ``Config`` for a configuration file."""
    from ode_vio_tpu_torch.config import Config, DataConfig, ModelConfig, SolverConfig

    return Config(model=ModelConfig(**cfg_file["model"]),
                  solver=SolverConfig(**cfg_file["solver"]),
                  cde_solver_cfg=SolverConfig(**cfg_file["cde_solver"]),
                  data=DataConfig(**cfg_file["data"]))


# The controls, runs that are never the benchmark's own, each of which
# has to come out not correct: ``int8`` runs the program with its own
# int8 trunk (``encoder_int8``, the precision below the stated bf16) in
# the window; each of the others puts the plain reference, one stage one
# precision lower than the configuration states, in the program's place
# (the window still runs the program), its poses compared in its stead.
STAND_INS = {"fp8": {"encoders": "float8_e4m3fn"}, "bf16-core": {"core": "bfloat16"},
             "tf32-core": {"core": "tf32"}}
CONTROLS = ("int8",) + tuple(STAND_INS)


class Run:
    """What a traffic kind is given: the cell, its mix and configuration,
    the seed, the device, the host spans and, when traced, the tracer."""

    def __init__(self, cell: dict, seed: int, seconds: float, device, spans,
                 tracer=None, control: Optional[str] = None):
        self.cell = cell
        self.control = control
        self.mix = cell["mix"]
        self.config = cell["config_file"]
        self.program_config = program_config(self.config)
        if control == "int8":
            pc = self.program_config
            self.program_config = dataclasses.replace(
                pc, model=dataclasses.replace(pc.model, encoder_int8=True))
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.spans = spans
        self.tracer = tracer
        self.limits = cell["limits"]
        self.counts: dict = {}   # what the readers read beside spans and trace
        self.trace = None

    def reference(self, weights, stand_in: bool = False):
        """The plain reference at the configuration's precisions; with
        ``stand_in``, the control's reference that takes the program's
        place, or None where no control or the program's own does."""
        from vio_bench.reference.model import ReferenceModel

        if stand_in and self.control not in STAND_INS:
            return None
        c = self.config
        return ReferenceModel(c["model"], c["solver"], c["cde_solver"], weights,
                              fold_bn=self.mix["fold_bn"],
                              **(STAND_INS[self.control] if stand_in else {}))


def card() -> dict:
    import torch

    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else "not read"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def forbidden_loaded() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def execute(run: Run, kind) -> dict:
    """Set-up, window, peak memory, release, check: what the result line
    needs besides the clocks of the caller."""
    import torch

    served = kind.prepare(run)
    if run.tracer is not None:
        run.tracer.start()
        served.warm_cycle()
        run.tracer.step()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"setup_end": time.perf_counter()}
    if run.tracer is not None:
        with run.tracer.window():
            served.window(run.seconds)
        run.trace = run.tracer.stop()
    else:
        served.window(run.seconds)
    out["window_end"] = time.perf_counter()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["end_to_end"] = served.end_to_end()
    served.release()
    t = time.perf_counter()
    out["check"] = served.check()
    print(f"vio_bench: the correctness check took {time.perf_counter() - t:.3f} s",
          file=sys.stderr, flush=True)
    out["attempted"], out["failed"] = served.attempted, served.failed
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="python -m vio_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a control run (see CONTROLS), never one of the benchmark's own
    ap.add_argument("--control", choices=CONTROLS, default=None)
    # the knee sweep: the mix's sessions replaced
    ap.add_argument("--sessions", type=int, default=None)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args, t_start)
    except Failure as e:
        print(f"vio_bench: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, t_start: float, device: str = "cuda", prepare_hook=None) -> dict:
    """The result of one run; ``device='cpu'`` and ``prepare_hook`` (given
    the traffic kind's served object) exist for the benchmark's own tests,
    which drive a run without a card."""
    root = Path.cwd()
    manifest = _load_json(root / "BENCHMARK.json")
    cell = load_cell(args.workload)
    if args.sessions is not None:
        cell["mix"]["sessions"] = args.sessions
    # build caches at fixed places inside the checkout (the program's own
    # kernels build into ``ode_vio_tpu_torch/_build``)
    cache = root / ".vio_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise Failure(f"the cell needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} found")
    if importlib.util.find_spec(PROGRAM) is None:
        raise Failure(f"the measured program ({PROGRAM}) is not in this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vio_bench.trace import DeviceTrace, Spans

    dev = torch.device(device)
    tracer = DeviceTrace(dev) if args.trace else None
    run = Run(cell, args.seed, args.seconds, dev, Spans(annotate=bool(args.trace)), tracer,
              args.control)
    info = card() if device == "cuda" else {"kind": "cpu", "count": 1,
                                            "power_limit": "not a card"}
    print(f"vio_bench: {cell['name']} seed {args.seed} on {info['kind']}, power limit "
          f"{info['power_limit']}" + (f", control {args.control}" if args.control else ""),
          file=sys.stderr, flush=True)
    kind = importlib.import_module(f"vio_bench.traffic.{cell['mix']['kind']}")
    if prepare_hook is not None:
        kind = prepare_hook(kind)
    out = execute(run, kind)
    setup_s = out["setup_end"] - t_start
    parts = {k: sum(run.spans.durations(k)) for k in run.spans.by_name if k.startswith("setup_")}
    print(f"vio_bench: set-up {setup_s:.3f} s, of which " + ", ".join(
        f"{k[6:]} {v:.3f} s" for k, v in parts.items()), file=sys.stderr, flush=True)
    loaded = forbidden_loaded()
    if loaded:
        raise Failure(f"modules of the JAX side are loaded: {loaded}")

    metrics = {}
    if args.trace:
        for entry in reported(manifest["per_layer"], cell["name"]):
            value = load_reader(entry["name"])(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for entry in reported(manifest["end_to_end"], cell["name"]):
            if entry["name"] not in values:
                raise Failure(f"the {cell['mix']['kind']} traffic gives no {entry['name']}")
            metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}
    correct, compared = out["check"]
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": info["kind"], "count": cell["chips"],
                         "memory_peak_bytes": out.get("memory_peak_bytes", 0)},
              "card": {"power_limit": info["power_limit"], "setup_s": setup_s,
                       "window_s": out["window_end"] - out["setup_end"]}}
    if args.trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    for name, c in compared.items():
        print(f"vio_bench: compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    result["compared"] = compared
    return result
