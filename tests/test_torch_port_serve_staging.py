"""The serving engine's resident lane batch (``serving/engine.py``) against
the staging it replaced, written here: every lane restaged from the host
each step, an idle lane from its last window, or from the prototype before
its first window and after its session closed. Poses, carry and the batch
itself are equal bit for bit; a window of another shape is refused; the
counter ``ode_vio.serve.lanes_staged`` counts the windows copied."""

import numpy as np
import pytest
import torch

from ode_vio_tpu_torch.config import ModelConfig
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.parallel.lanes import split_lanes
from ode_vio_tpu_torch.serving.engine import StreamingEngine
from ode_vio_tpu_torch.training.loop import make_infer_fn
from ode_vio_tpu_torch.utils import profiling

S, H, W = 3, 32, 64
TINY = dict(img_w=W, img_h=H, seq_len=S, v_f_len=64, i_f_len=32, ode_hidden_dim=32,
            rnn_num_layers=2, ode_activation_fn="softplus", ode_fn_num_layers=2,
            fuse_method="soft", compute_dtype="float32")


@pytest.fixture(autouse=True)
def one_thread_and_empty_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(threads)


def window(seed, t0, s=S):
    rng = np.random.default_rng(seed)
    return (rng.random((s, H, W, 3), np.float32) - 0.5,
            rng.standard_normal((10 * (s - 1) + 1, 6)).astype(np.float32),
            t0 + np.cumsum(rng.uniform(0.08, 0.13, s)))


class Restage:
    """The engine's contract with the whole batch built on the host every
    step by ``np.stack`` and copied by ``split_lanes``."""

    def __init__(self, model, sd, n, devices):
        self.infer = split_lanes(make_infer_fn(model, sd, fold_bn=True, device=devices[0]),
                                 devices)
        self.n, self.per, self.axis = n, n // len(devices), model.carry_lane_axis
        self.last, self.t_off, self.fresh = {}, {}, set()
        self.carry, self.proto, self.batch = None, None, None

    def open(self, lane):
        self.fresh.add(lane)
        if self.carry is not None:
            part, local = divmod(lane, self.per)
            with torch.inference_mode():
                self.carry[part].select(self.axis, local).zero_()

    def close(self, lane):
        self.last.pop(lane, None)
        self.fresh.discard(lane)

    def step(self, windows):
        if self.proto is None:
            imgs, imus, ts = next(iter(windows.values()))
            self.proto = (np.zeros_like(imgs), np.zeros_like(imus),
                          np.arange(len(ts), dtype=np.float32) * 0.1)
        for lane, (imgs, imus, ts) in windows.items():
            if lane in self.fresh:
                self.t_off[lane] = ts[0]
                self.fresh.discard(lane)
            self.last[lane] = (imgs, imus, (ts - self.t_off[lane]).astype(np.float32))
        lanes = [self.last.get(ln, self.proto) for ln in range(self.n)]
        self.batch = [torch.from_numpy(np.stack([w[k] for w in lanes])) for k in range(3)]
        active = np.array([ln in windows for ln in range(self.n)])
        poses, carry = self.infer(*self.batch, self.carry, active=active)
        old = self.carry if self.carry is not None else [torch.zeros_like(c) for c in carry]
        shape = [1] * carry[0].dim()
        shape[self.axis] = self.per
        self.carry = [torch.where(m.to(c.device).reshape(shape), c, o)
                      for m, c, o in zip(torch.from_numpy(active).split(self.per), carry, old)]
        return {ln: poses.numpy()[ln] for ln in windows}


# (opened before the step, closed before the step, sessions stepped): lanes
# open late and idle, session 0 closes and its lane reopens for session 3
SCHEDULE = [((0, 1, 2), (), (0, 1)),
            ((), (), (0, 2)),
            ((), (), (1,)),
            ((), (0,), (1, 2)),
            ((3,), (), (3, 2)),
            ((), (), (3,))]


def serve_both(engine, oracle):
    """SCHEDULE through ``engine`` and ``oracle``, poses, carry and lane
    batch compared bit for bit after every step; returns the sessions'
    lanes and the windows submitted."""
    lane, submitted = {}, 0
    for k, (opens, closes, stepped) in enumerate(SCHEDULE):
        for s in closes:
            engine.close_session(lane[s])
            oracle.close(lane[s])
        for s in opens:
            lane[s] = engine.open_session()
            oracle.open(lane[s])
        # each session's clock starts far from 0: the engine re-bases it
        wins = {lane[s]: window(10 * k + s, 100.0 * (s + 1) + 0.5 * k) for s in stepped}
        got, want = engine.step(wins), oracle.step(wins)
        submitted += len(wins)
        assert got.keys() == want.keys()
        for ln in got:
            np.testing.assert_array_equal(got[ln], want[ln])
        for a, b in zip(engine._carry, oracle.carry):
            assert torch.equal(a, b), f"step {k}"
        for blocks, whole in zip(engine._batch, oracle.batch):
            assert torch.equal(torch.cat(blocks).cpu(), whole), f"step {k}"
    assert lane[3] == lane[0]
    return lane, submitted


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("core", ["ode-rnn", "rnn"])
def test_resident_batch_equals_restaging(core, replicas):
    torch.manual_seed(0)
    model = DeepVIO(ModelConfig(model_type=core, **TINY))
    sd = model.state_dict()
    devices = ["cpu"] * replicas
    engine = StreamingEngine(model, sd, max_sessions=4, device="cpu", devices=devices)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, submitted = serve_both(engine, Restage(model, sd, 4, devices))
    staged = [c.value for c in profiling.record()["counts"]
              if c.name == "ode_vio.serve.lanes_staged"]
    assert len(staged) == len(SCHEDULE) and sum(staged) == submitted


def test_window_of_another_shape_is_refused():
    torch.manual_seed(0)
    engine = StreamingEngine(DeepVIO(ModelConfig(**TINY)), max_sessions=2, device="cpu")
    a, b = engine.open_session(), engine.open_session()
    engine.step({a: window(0, 1.0)})
    carry = engine._carry[0].clone()
    with pytest.raises(ValueError, match=r"\(4, 32, 64, 3\).*\(3, 32, 64, 3\)"):
        engine.step({a: window(1, 2.0), b: window(2, 3.0, s=S + 1)})
    # nothing was staged: the refused step left the engine as it was
    assert torch.equal(engine._carry[0], carry)
    assert b in engine._fresh
