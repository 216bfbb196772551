"""The program's own spans and counters (``utils/profiling.py``: ``span``,
``count``, ``record``): off without a profiler, nested and on the trace's
clock with one, and in place in the serving engine, the cde core and the
evaluator without changing a bit of what they compute."""

import json

import numpy as np
import pytest
import torch

from ode_vio_tpu_torch.config import ModelConfig, SolverConfig
from ode_vio_tpu_torch.data.evaluation import KittiEvaluator
from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.pose_cde import PoseCDE
from ode_vio_tpu_torch.serving.engine import StreamingEngine
from ode_vio_tpu_torch.utils import profiling

from torch_port_helpers import TINY, one_torch_thread, window  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


def test_span_without_a_profiler_records_nothing(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range was opened for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not profiling.collecting()
    assert profiling.span("ode_vio.a.b") is profiling.span("ode_vio.c.d")
    with profiling.span("ode_vio.a.b"):
        with profiling.span("ode_vio.a.c"):
            profiling.count("ode_vio.a.n", torch.tensor(3), 2)
    assert profiling.record() == {"spans": [], "counts": []}


def test_nested_spans_under_a_profiler(tmp_path):
    with profiler() as prof:
        with profiling.span("ode_vio.t.outer"):
            with profiling.span("ode_vio.t.middle"):
                with profiling.span("ode_vio.t.inner"):
                    profiling.count("ode_vio.t.work", torch.tensor([7], dtype=torch.int32), 3)
            with profiling.span("ode_vio.t.second"):
                pass
        with profiling.span("ode_vio.t.next"):
            profiling.count("ode_vio.t.work", 5)
    profiling.count("ode_vio.t.work", 100)   # the profiler has stopped
    rec = profiling.record()
    spans = rec["spans"]
    assert [s.name for s in spans] == ["ode_vio.t.inner", "ode_vio.t.middle",
                                       "ode_vio.t.second", "ode_vio.t.outer",
                                       "ode_vio.t.next"]
    by = {s.name: s for s in spans}
    assert [by[n].parent for n in ("ode_vio.t.inner", "ode_vio.t.middle", "ode_vio.t.second",
                                   "ode_vio.t.outer", "ode_vio.t.next")] == [
        "ode_vio.t.middle", "ode_vio.t.outer", "ode_vio.t.outer", None, None]
    # the spans of one top-level span share its ordinal; the next has the next
    outer = by["ode_vio.t.outer"].step
    assert {s.step for s in spans[:4]} == {outer} and by["ode_vio.t.next"].step == outer + 1
    for child, parent in (("inner", "middle"), ("middle", "outer"), ("second", "outer")):
        c, p = by[f"ode_vio.t.{child}"], by[f"ode_vio.t.{parent}"]
        assert p.t0 <= c.t0 <= c.t1 <= p.t1
    assert by["ode_vio.t.outer"].t1 <= by["ode_vio.t.next"].t0
    assert [(c.name, c.value) for c in rec["counts"]] == [("ode_vio.t.work", 21),
                                                          ("ode_vio.t.work", 5)]
    assert by["ode_vio.t.inner"].t0 <= rec["counts"][0].t <= by["ode_vio.t.inner"].t1
    assert profiling.record() == rec   # reading does not clear
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == sorted(s.name for s in spans)


SERVE_STEP = ["ode_vio.serve.gather", "ode_vio.serve.stack"]


def serve(engine, steps):
    """Three sessions, the second idle in the second step; the poses of
    every step and each step's carry."""
    out = []
    lanes = [engine.open_session() for _ in range(3)]
    for k in range(steps):
        batch = {ln: window(10 * k + ln, t0=0.5 * k, s=TINY["seq_len"])
                 for ln in lanes if not (k == 1 and ln == lanes[1])}
        poses = engine.step(batch)
        out.append(({ln: p.copy() for ln, p in poses.items()},
                    [c.clone() for c in engine._carry]))
    return out


@pytest.mark.parametrize("replicas", [1, 2])
def test_engine_spans_leave_every_bit(replicas):
    torch.manual_seed(0)
    model = DeepVIO(ModelConfig(**TINY))
    sd = model.state_dict()
    devices = ["cpu"] * replicas

    def engine():
        return StreamingEngine(model, sd, max_sessions=4, device="cpu", devices=devices)

    off = serve(engine(), 3)
    assert profiling.record()["spans"] == []
    with profiler():
        on = serve(engine(), 3)
    for (p_off, c_off), (p_on, c_on) in zip(off, on):
        assert p_off.keys() == p_on.keys()
        for lane in p_off:
            np.testing.assert_array_equal(p_off[lane], p_on[lane])
        for a, b in zip(c_off, c_on):
            assert torch.equal(a, b)
    spans = profiling.record()["spans"]
    per_step = (SERVE_STEP + ["ode_vio.lanes.h2d"] + ["ode_vio.lanes.forward"] * replicas
                + ["ode_vio.lanes.readback", "ode_vio.serve.carry", "ode_vio.serve.step"])
    assert [s.name for s in spans] == per_step * 3
    for k in range(3):
        step = spans[len(per_step) * (k + 1) - 1]
        children = spans[len(per_step) * k: len(per_step) * (k + 1) - 1]
        assert step.parent is None
        assert all(c.parent == "ode_vio.serve.step" and c.step == step.step for c in children)
        assert all(step.t0 <= c.t0 <= c.t1 <= step.t1 for c in children)
        assert all(a.t1 <= b.t0 for a, b in zip(children, children[1:]))
    assert len({s.step for s in spans}) == 3


EVAL_STEP = ["ode_vio.eval.decode_wait", "ode_vio.eval.assemble", "ode_vio.eval.stage",
             "ode_vio.eval.forward", "ode_vio.eval.step"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames written at 120x360, so that each step waits milliseconds for
    its decode, a thousand times the spans' own cost."""
    return make_kitti_tree(tmp_path_factory.mktemp("span_tree"), seqs=("00", "05"),
                           n_frames=24, img_hw=(120, 360), speed_scale=40.0)


@pytest.mark.parametrize("batched", [True, False])
def test_eval_spans_hold_the_decode_wait(tree, batched):
    seq_len = 4

    def zeros(imgs, imus, ts, carry=None):
        return np.zeros((imgs.shape[0], seq_len - 1, 6), np.float32), carry

    ev = KittiEvaluator(tree, ("00", "05"), seq_len, (32, 64), 0.3,
                        rng=np.random.default_rng(0))
    with profiler():
        ev.eval(zeros, batched=batched)
    spans = profiling.record()["spans"]
    windows = [len(p) for p in ev.partitions]
    steps = max(windows) if batched else sum(windows)
    assert [s.name for s in spans] == EVAL_STEP * steps
    for k in range(steps):
        step = spans[5 * k + 4]
        assert all(c.parent == "ode_vio.eval.step" and c.step == step.step
                   and step.t0 <= c.t0 <= c.t1 <= step.t1 for c in spans[5 * k: 5 * k + 4])
    waited = sum(s.t1 - s.t0 for s in spans if s.name == "ode_vio.eval.decode_wait")
    assert ev.timing["decode_wait_s"] > 0
    assert waited == pytest.approx(ev.timing["decode_wait_s"], rel=0.01)


@pytest.mark.parametrize("mode", ["carry", "history"])
def test_cde_spans_leave_every_bit(mode):
    """PoseCDE over two windows: ``ode_vio.cde.path`` then
    ``ode_vio.cde.solve`` each window, and in history mode
    ``ode_vio.cde.evict`` before the carried window's solve; poses and carry
    bit for bit with the profiler on and off."""
    cfg = ModelConfig(model_type="cde", v_f_len=16, i_f_len=8, cde_hidden_dim=8,
                      cde_streaming_mode=mode, cde_history_cap=8, use_kernels=False)
    torch.manual_seed(3)
    core = PoseCDE(cfg, SolverConfig(rtol=1e-3, atol=1e-6, max_steps=64)).eval()
    g = torch.Generator().manual_seed(4)
    wins = [(0.3 * torch.randn(2, 3, 16, generator=g), 0.3 * torch.randn(2, 3, 8, generator=g),
             k + torch.cumsum(0.08 + 0.05 * torch.rand(2, 4, generator=g), 1)) for k in range(2)]

    def run():
        carry, out = None, []
        with torch.no_grad():
            for fv, fi, ts in wins:
                poses, carry, _ = core(fv, fi, ts, prev=carry)
                out.append((poses, carry))
        return out

    plain = run()
    with profiler():
        traced = run()
    names = [sp.name for sp in profiling.record()["spans"]]
    want = ["ode_vio.cde.path", "ode_vio.cde.solve"] * 2
    if mode == "history":
        want.insert(3, "ode_vio.cde.evict")
    assert names == want
    for (a, ca), (b, cb) in zip(plain, traced):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        for x, y in zip(ca.values() if mode == "history" else [ca],
                        cb.values() if mode == "history" else [cb]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
