"""Which device records a ``torch.profiler`` trace loses, under the whole
of ``chip_smoke.py``.

Runs ``chip_smoke.py`` with its edges phase's ``--profile_dir`` check
(``profile_check``: one flagship ``cli.train`` epoch, the trace of steps
1-4) made three times in a row, and prints for each trace, on lines that
begin with ``trace_records``: the events by category, the kernel and K3
events, the kernel launches whose kernel has no record in the trace (by
correlation id, with the host operations around them), and K3's
timestamps. It passes the first trace that holds the check, and fails
where none does.

Run it on the card from the repository's root::

    python ode_vio_tpu_torch/probes/trace_records.py > trace_records.log 2>&1
"""

import collections
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TRIES = 3


def report(prof_dir: Path) -> None:
    """Print what the trace in ``prof_dir`` holds, then remove it."""
    (path,) = list(prof_dir.glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k3 = sorted((e for e in kernels if "fused_dropout" in e["name"]), key=lambda e: e["ts"])
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    launches = [e for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")]
    lost = [e for e in launches if e.get("args", {}).get("correlation") not in recorded]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    t0 = min(e["ts"] for e in events if "ts" in e)
    print("trace_records categories", dict(collections.Counter(e.get("cat") for e in events)))
    print("trace_records kernels", len(kernels), "k3", len(k3), "launches", len(launches),
          "launches without a kernel record", len(lost))
    for e in lost[:20]:
        around = [o["name"] for o in ops if o["ts"] <= e["ts"] <= o["ts"] + o.get("dur", 0)]
        print("trace_records   lost", e.get("args", {}).get("correlation"),
              f"{e['ts'] - t0:.1f} us", around[-4:])
    print("trace_records k3 us", [round(e["ts"] - t0) for e in k3])
    shutil.rmtree(prof_dir)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    check = chip_smoke.profile_check

    def repeated(dev, work, root):
        held = None
        for i in range(TRIES):
            try:
                out = check(dev, work, root)
                print("trace_records try", i, "held:", out["kernel_events"], "kernel events, K3",
                      out["k3_kernel_events"], flush=True)
                held = out
            except AssertionError as e:
                print("trace_records try", i, "failed:", e, flush=True)
            report(work / "profile")
            shutil.rmtree(work / "edges_train", ignore_errors=True)
        if held is None:
            raise AssertionError(f"trace_records: no trace of {TRIES} held the check")
        return held

    chip_smoke.profile_check = repeated
    chip_smoke.main()


if __name__ == "__main__":
    main()
