"""The serving engine (``serving/engine.py``) against two oracles written
here, each of which restages every lane from the host each step (an idle
lane from its last window, or from the prototype before its first window
and after its session closed):

* ``Restage``, the engine's contract before its feature cache and the JAX
  engine's: the whole batch through the encoders and the pose core;
* ``Reencode``, its contract with the cache: each block's submitted lanes
  through the encoders as a batch of their own, padded with the first of
  them to ``encoder_bucket``'s rows; every other lane keeps the features
  of its last window (the prototype's, encoded alone, before its first
  window and after its session closed); the pose core over every lane.

Against ``Reencode`` poses, carry, the lane batch and the feature cache
are equal bit for bit. Against ``Restage`` an idle lane's carry is left as
it was, bit for bit, and a served lane agrees within the encoders'
rounding at another batch size (bit for bit in bfloat16, whose CPU
convolutions give a row the same bits at any batch). The cache, the
buckets, the counters ``ode_vio.serve.lanes_staged`` and
``lanes_encoded``, and hard fusion's noise are held on their own; a window
of another shape is refused."""

import dataclasses

import numpy as np
import pytest
import torch

from ode_vio_tpu_torch.config import ModelConfig
from ode_vio_tpu_torch.models.deepvio import DeepVIO
from ode_vio_tpu_torch.models.encoders import ImageEncoder
from ode_vio_tpu_torch.models.fold import fold_batchnorm_into_bias
from ode_vio_tpu_torch.parallel.lanes import split_lanes
from ode_vio_tpu_torch.serving.engine import StreamingEngine
from ode_vio_tpu_torch.training.loop import encoder_bucket, make_infer_fn
from ode_vio_tpu_torch.utils import profiling

S, H, W = 3, 32, 64
TINY = dict(img_w=W, img_h=H, seq_len=S, v_f_len=64, i_f_len=32, ode_hidden_dim=32,
            rnn_num_layers=2, ode_activation_fn="softplus", ode_fn_num_layers=2,
            fuse_method="soft", compute_dtype="float32")
CDE_TINY = dict(cde_hidden_dim=8, cde_fn_num_layers=2)


@pytest.fixture(autouse=True)
def one_thread_and_empty_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(threads)


def window(seed, t0, s=S, hw=(H, W)):
    rng = np.random.default_rng(seed)
    return (rng.random((s, *hw, 3), np.float32) - 0.5,
            rng.standard_normal((10 * (s - 1) + 1, 6)).astype(np.float32),
            t0 + np.cumsum(rng.uniform(0.08, 0.13, s)))


def tiny_model(core="ode-rnn", **fields):
    torch.manual_seed(0)
    return DeepVIO(ModelConfig(model_type=core, **dict(TINY, **CDE_TINY, **fields)))


class Restage:
    """The engine's contract with the whole batch built on the host every
    step by ``np.stack``, copied by ``split_lanes`` and run through the
    encoders and the pose core; cde/rde lanes that start beside carried
    ones get the ``cold`` mask."""

    def __init__(self, model, sd, n, devices):
        self.infer = split_lanes(make_infer_fn(model, sd, fold_bn=True, device=devices[0]),
                                 devices)
        self.n, self.per, self.axis = n, n // len(devices), model.carry_lane_axis
        self.cold_mask = model.cold_mask
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

    def forward(self, active, cold):
        return self.infer(*self.batch, self.carry, active=active, **cold)

    def step(self, windows):
        if self.proto is None:
            imgs, imus, ts = next(iter(windows.values()))
            self.proto = (np.zeros_like(imgs), np.zeros_like(imus),
                          np.arange(len(ts), dtype=np.float32) * 0.1)
        cold = {}
        if self.cold_mask and self.carry is not None:
            fresh = np.array([ln in windows and ln in self.fresh for ln in range(self.n)])
            if fresh.any():
                cold["cold"] = fresh
        for lane, (imgs, imus, ts) in windows.items():
            if lane in self.fresh:
                self.t_off[lane] = ts[0]
                self.fresh.discard(lane)
            self.last[lane] = (imgs, imus, (ts - self.t_off[lane]).astype(np.float32))
        lanes = [self.last.get(ln, self.proto) for ln in range(self.n)]
        self.batch = [torch.from_numpy(np.stack([w[k] for w in lanes])) for k in range(3)]
        active = np.array([ln in windows for ln in range(self.n)])
        poses, carry = self.forward(active, cold)
        old = self.carry if self.carry is not None else [torch.zeros_like(c) for c in carry]
        shape = [1] * carry[0].dim()
        shape[self.axis] = self.per
        self.carry = [torch.where(m.to(c.device).reshape(shape), c, o)
                      for m, c, o in zip(torch.from_numpy(active).split(self.per), carry, old)]
        return {ln: poses.numpy()[ln] for ln in windows}


def folded_net(model, sd, device="cpu"):
    """``model`` with ``sd``'s BatchNorm folded into the conv biases, as
    the engine's copy holds it."""
    net = DeepVIO(dataclasses.replace(model.cfg, skip_bn=True), model.solver, model.cde_solver)
    net.load_state_dict(fold_batchnorm_into_bias(sd))
    return net.to(device).eval()


def cache(engine, j):
    """Feature ``j`` (0 visual, 1 inertial) of the engine's cache, every
    lane in order, on the CPU."""
    return torch.cat([f[j] for f in engine._feats]).cpu()


class Reencode(Restage):
    """The engine's contract with its feature cache, on a BatchNorm-folded
    copy of the model per block: the submitted lanes of a block encoded as
    their own batch, padded with the first of them to its bucket; each
    other lane's features its last ones, or the prototype's encoded alone;
    the pose core over every lane of the block."""

    def __init__(self, model, sd, n, devices):
        super().__init__(model, sd, n, devices)
        self.nets = [folded_net(model, sd, dev) for dev in devices]
        self.feats = None  # per lane: (visual, inertial)

    def close(self, lane):
        super().close(lane)
        if self.feats is not None:
            self.feats[lane] = self.proto_feats

    @torch.inference_mode()
    def forward(self, active, cold):
        if self.feats is None:
            dev = next(self.nets[0].parameters()).device
            one = [torch.from_numpy(a)[None].to(dev) for a in self.proto[:2]]
            self.proto_feats = tuple(f[0].cpu() for f in self.nets[0].encode(*one))
            self.feats = [self.proto_feats] * self.n
        poses, carries = [], []
        for part, net in enumerate(self.nets):
            dev = next(net.parameters()).device
            block = range(part * self.per, (part + 1) * self.per)
            rows = [ln for ln in block if active[ln]]
            if rows:
                padded = rows + rows[:1] * (encoder_bucket(len(rows), self.per) - len(rows))
                v, i = net.encode(*(torch.stack([self.batch[k][ln] for ln in padded]).to(dev)
                                    for k in (0, 1)))
                for j, ln in enumerate(rows):
                    self.feats[ln] = (v[j].cpu(), i[j].cpu())
            fv, fi = (torch.stack([self.feats[ln][k] for ln in block]).to(dev) for k in (0, 1))
            p, c, _ = net.pose_from_features(
                fv, fi, self.batch[2][block.start:block.stop].to(dev),
                None if self.carry is None else self.carry[part],
                cold=cold["cold"][block.start:block.stop] if cold else None)
            poses.append(p.cpu())
            carries.append(c)
        return torch.cat(poses), carries


# (opened before the step, closed before the step, sessions stepped): lanes
# open late and idle, session 0 closes and its lane reopens for session 3
SCHEDULE = [((0, 1, 2), (), (0, 1)),
            ((), (), (0, 2)),
            ((), (), (1,)),
            ((), (0,), (1, 2)),
            ((3,), (), (3, 2)),
            ((), (), (3,))]


def steps(engine, oracle, make_window=window):
    """SCHEDULE through ``engine`` and ``oracle``, a step at a time: yields
    the step's number, the windows, both sides' poses and the engine's
    carry before the step (None before its first)."""
    lane = {}
    for k, (opens, closes, stepped) in enumerate(SCHEDULE):
        for s in closes:
            engine.close_session(lane[s])
            oracle.close(lane[s])
        for s in opens:
            lane[s] = engine.open_session()
            oracle.open(lane[s])
        # each session's clock starts far from 0: the engine re-bases it
        wins = {lane[s]: make_window(10 * k + s, 100.0 * (s + 1) + 0.5 * k) for s in stepped}
        before = None if engine._carry is None else [c.clone() for c in engine._carry]
        yield k, wins, engine.step(wins), oracle.step(wins), before
    assert lane[3] == lane[0]


def serve_both(engine, oracle, make_window=window):
    """SCHEDULE through ``engine`` and ``oracle``, poses, carry, lane batch
    and (against ``Reencode``) feature cache compared bit for bit after
    every step; returns the windows submitted."""
    submitted = 0
    for k, wins, got, want, _ in steps(engine, oracle, make_window):
        submitted += len(wins)
        assert got.keys() == want.keys()
        for ln in got:
            np.testing.assert_array_equal(got[ln], want[ln])
        for a, b in zip(engine._carry, oracle.carry):
            assert torch.equal(a, b), f"step {k}"
        for blocks, whole in zip(engine._batch, oracle.batch):
            assert torch.equal(torch.cat(blocks).cpu(), whole), f"step {k}"
        if isinstance(oracle, Reencode):
            for j in (0, 1):
                want = torch.stack([f[j] for f in oracle.feats])
                assert torch.equal(cache(engine, j), want.cpu()), f"step {k}"
    return submitted


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("core", ["ode-rnn", "rnn"])
def test_resident_batch_equals_restaging(core, replicas):
    model = tiny_model(core)
    sd = model.state_dict()
    devices = ["cpu"] * replicas
    engine = StreamingEngine(model, sd, max_sessions=4, device="cpu", devices=devices)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        submitted = serve_both(engine, Reencode(model, sd, 4, devices))
    staged = [c.value for c in profiling.record()["counts"]
              if c.name == "ode_vio.serve.lanes_staged"]
    assert len(staged) == len(SCHEDULE) and sum(staged) == submitted


# float32: the widest gap of a served lane's poses and carry to the
# all-lanes forward over SCHEDULE at 8 lanes read 3.0e-8 and 6.0e-8
# (ode-rnn), 2.2e-8 and 3.4e-8 (cde) on one replica, 0 on two (an Intel
# Xeon, one torch thread); the encoders alone differ by up to 7.8e-8
# between a batch of 8 and one of 1-4. The limit leaves room for another
# CPU's kernels.
F32_GAP = 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("core", ["ode-rnn", "cde"])
def test_served_lanes_match_the_all_lanes_forward(core, replicas, dtype):
    model = tiny_model(core, compute_dtype=dtype)
    sd = model.state_dict()
    devices = ["cpu"] * replicas
    engine = StreamingEngine(model, sd, max_sessions=8, device="cpu", devices=devices)
    oracle = Restage(model, sd, 8, devices)
    axis = model.carry_lane_axis
    atol = F32_GAP if dtype == "float32" else 0.0
    for k, wins, got, want, before in steps(engine, oracle):
        for ln in got:
            np.testing.assert_allclose(got[ln], want[ln], rtol=0, atol=atol, err_msg=f"{k}")
        carry = torch.cat(engine._carry, axis)
        torch.testing.assert_close(carry, torch.cat(oracle.carry, axis), rtol=0, atol=atol)
        if before is not None:
            idle = torch.tensor([ln for ln in range(8) if ln not in wins])
            assert torch.equal(carry.index_select(axis, idle),
                               torch.cat(before, axis).index_select(axis, idle)), f"step {k}"


def test_feature_cache_holds_the_prototype():
    """After ``warmup`` every row holds the prototype's features (encoded
    alone); a lane never served keeps them; a closed lane gets them back."""
    model = tiny_model()
    sd = model.state_dict()
    engine = StreamingEngine(model, sd, max_sessions=4, device="cpu", devices=["cpu", "cpu"])
    engine.warmup(window(0, 0.0))
    with torch.inference_mode():
        proto = folded_net(model, sd).encode(*(torch.from_numpy(a)[None]
                                               for a in engine._proto[:2]))

    def holds_proto(lanes):
        for j, p in enumerate(proto):
            rows = cache(engine, j)[lanes]
            assert torch.equal(rows, p.expand_as(rows)), lanes

    holds_proto([0, 1, 2, 3])
    a, b, c = (engine.open_session() for _ in range(3))
    engine.step({a: window(1, 5.0), c: window(2, 9.0)})
    holds_proto([b, 3])
    assert not torch.equal(cache(engine, 0)[a], proto[0][0])
    engine.close_session(a)
    holds_proto([a, b, 3])
    engine.step({c: window(3, 9.5)})
    holds_proto([a, b, 3])


def test_encoders_run_at_the_bucket_of_the_submitted_lanes(monkeypatch):
    """Two blocks of 4 lanes: ``warmup`` runs the image encoder at every
    bucket (1, 2, 4) on each; a step runs it once per block that has a
    submitted lane, at that block's bucket; ``ode_vio.serve.lanes_encoded``
    counts those rows, once a batch."""
    batches = []
    forward = ImageEncoder.forward

    def recorded(self, img, *args, **kwargs):
        batches.append(img.shape[0])
        return forward(self, img, *args, **kwargs)

    monkeypatch.setattr(ImageEncoder, "forward", recorded)
    engine = StreamingEngine(tiny_model(), max_sessions=8, device="cpu", devices=["cpu", "cpu"])
    engine.warmup(window(0, 0.0))
    # the prototype alone on each block, then each bucket on each block
    assert batches == [1, 1, 1, 1, 2, 2, 4, 4]
    lanes = [engine.open_session() for _ in range(8)]
    plan = [([0], [1]), ([0, 1, 2], [4]), ([0, 4, 5], [1, 2]), (range(8), [4, 4]),
            ([3, 5, 6, 7], [1, 4])]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for served, want in plan:
            del batches[:]
            before = len(profiling.record()["counts"])
            engine.step({lanes[i]: window(i, 10.0 * i) for i in served})
            assert batches == want, served
            encoded = [c.value for c in profiling.record()["counts"][before:]
                       if c.name == "ode_vio.serve.lanes_encoded"]
            assert encoded == want, served


def test_hard_fusion_poses_do_not_depend_on_other_lanes():
    """Hard fusion's Gumbel noise is drawn in the pose core for every lane:
    a session's poses come out the same whether the other lanes submitted
    windows or idled (to rounding, far below the mask's effect), and
    another lane's noise would move them."""
    model = tiny_model(fuse_method="hard", compute_dtype="bfloat16")
    sd = model.state_dict()
    out = []
    for served in ([0, 1, 2, 3], [2]):
        engine = StreamingEngine(model, sd, max_sessions=4, device="cpu")
        lanes = [engine.open_session() for _ in range(4)]
        engine.step({ln: window(ln, 1.0 * ln) for ln in lanes})
        out.append(engine.step({lanes[i]: window(10 + i, 5.0 + i) for i in served})[lanes[2]])
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=1e-6)
    # the same window on lane 1, which draws other noise, lands elsewhere
    engine = StreamingEngine(model, sd, max_sessions=4, device="cpu")
    lanes = [engine.open_session() for _ in range(4)]
    engine.step({lanes[1]: window(2, 2.0)})
    other = engine.step({lanes[1]: window(12, 7.0)})[lanes[1]]
    assert np.abs(other - out[1]).max() > 1e-3


def test_window_of_another_shape_is_refused():
    engine = StreamingEngine(tiny_model(), max_sessions=2, device="cpu")
    a, b = engine.open_session(), engine.open_session()
    engine.step({a: window(0, 1.0)})
    carry = engine._carry[0].clone()
    with pytest.raises(ValueError, match=r"\(4, 32, 64, 3\).*\(3, 32, 64, 3\)"):
        engine.step({a: window(1, 2.0), b: window(2, 3.0, s=S + 1)})
    # nothing was staged: the refused step left the engine as it was
    assert torch.equal(engine._carry[0], carry)
    assert b in engine._fresh
