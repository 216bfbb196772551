"""Data parallelism in the port (``parallel/mesh.py``) on the CPU, at the
tiny widths of ``torch_port_helpers.TINY`` in float32.

One world of two ``gloo`` ranks, started once for the module, runs every
train-step case (``torch_mesh_workers.py``, which imports no JAX) on its
rows of the global batch of 4: the fresh step with gradient accumulation
1 and 2, the carried step and the streaming (TBPTT) step, each for two
steps with no dropout (the frozen image encoder's inference graph), the
trunk trained in train mode at dropout rate 0, a world of one data and
two model coordinates, and a step with trunk dropout (K3's plain
version). Held against:

  * the JAX package's step sharded over a 2-device CPU mesh
    (``create_mesh(2, 1, devices=jax.devices()[:2])``, as
    tests/test_train.py holds it against its one-device step; accum2's
    over the (2, 2) mesh of the split case below), from the
    same weights through the bridge: each step's loss at rtol 1e-5 (the
    other metrics at 1e-4, as the one-process parity holds them), the
    parameters and statistics by ``compare_state``'s rule (rtol 1e-4,
    atol 1e-6, where the gradient clears rounding);
  * the port's own one-process step at the global batch: every metric at
    rtol 1e-5, the parameters and statistics at rtol 1e-5, atol 1e-6 on
    the same rule;
  * each other: the ranks' whole states (model, optimizer, step,
    generator) bit for bit after the steps.

A world of four ranks on a ``(2, 2)`` mesh runs the ``accum2`` case
with the parameters ``param_sharding_rules`` splits stored as slices
over the model axis (``create_train_state(split_params=True)``), held
against the JAX step sharded over a ``(2, 2)`` mesh with those rules
applied (as the ``accum2`` case), against the port's one-process step
(every metric at rtol 1e-5, the tensors as above), each rank's stored
shapes against the rules' slices, its gathered ``state_dict()`` through
the weight bridge both ways and its checkpoint, bit for bit;
``dryrun_multichip(4, "cpu")`` itself is a slow test.

The ranks' global BatchNorm statistics are held against one process's at
rtol 1e-5 (features) and 1e-6 (running statistics); eval lanes and the
serving engine split over two CPU replicas against unsplit at atol 1e-5
(the cde core's against each replica's lanes unsplit);
the sharding rule and the data-axis choice against JAX's; and the
training command line as two ranks it starts itself, resumed by a
``--multihost`` job of two processes from the launcher's variables,
against the run that did not stop, bit for bit.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from ode_vio_tpu import config as jcfg
from ode_vio_tpu.models.convert import convert_deepvio, trunk_out_hw
from ode_vio_tpu.models.deepvio import create_model as jax_create_model
from ode_vio_tpu.models.deepvio import init_model
from ode_vio_tpu.parallel import mesh as jmesh
from ode_vio_tpu.training import loop as jloop
from ode_vio_tpu_torch import config as tcfg
from ode_vio_tpu_torch.cli.train import main as train_main
from ode_vio_tpu_torch.data.evaluation import KittiEvaluator, eval_runs
from ode_vio_tpu_torch.data.synthetic import make_kitti_tree
from ode_vio_tpu_torch.entry import dryrun_config, dryrun_multichip
from ode_vio_tpu_torch.models.common import RankKeys, draw_key, mix_key
from ode_vio_tpu_torch.models.convert import from_jax_variables
from ode_vio_tpu_torch.models.deepvio import DeepVIO, create_model
from ode_vio_tpu_torch.models.encoders import TRUNK, ImageEncoder
from ode_vio_tpu_torch.parallel import mesh as tmesh
from ode_vio_tpu_torch.serving import StreamingEngine
from ode_vio_tpu_torch.training.checkpoint import CheckpointManager
from ode_vio_tpu_torch.training.loop import make_infer_fn

from torch_port_helpers import TINY, one_torch_thread, randomize_batchnorm  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = Path(__file__).resolve().parent.parent
B, S, H, W = 4, TINY["seq_len"], TINY["img_h"], TINY["img_w"]
T0 = 0.6  # the streaming case's second window starts here
TRUNK0 = tuple((f, k, s, 0.0) for f, k, s, _ in TRUNK)
NO_DROPOUT = dict(freeze_encoder=True, frozen_encoder_eval=True)
# name -> (kind, train fields, mesh, trunk); the first four are held against JAX
CASES = {
    "fresh": ("fresh", NO_DROPOUT, (2, 1), None),
    "accum2": ("fresh", dict(NO_DROPOUT, grad_accumulation_steps=2), (2, 1), None),
    "carry": ("carry", NO_DROPOUT, (2, 1), None),
    "stream": ("stream", NO_DROPOUT, (2, 1), None),
    "trunk": ("fresh", dict(weight_decay=0.0), (2, 1), TRUNK0),  # one step
    "model2": ("fresh", NO_DROPOUT, (1, 2), None),
    "keys": ("fresh", dict(freeze_encoder=True), (2, 1), None),
}
JAX_CASES = ("fresh", "accum2", "carry", "stream")
# the accum2 case on a (2, 2) mesh with split parameters, in a world of its own
SPLIT_MESH = (2, 2)


def configs(**train):
    return (jcfg.Config(model=jcfg.ModelConfig(**TINY), data=jcfg.DataConfig(seq_len=S),
                        train=jcfg.TrainConfig(batch_size=B, **train)),
            tcfg.Config(model=tcfg.ModelConfig(**TINY),
                        train=tcfg.TrainConfig(batch_size=B, **train)))


def train_batch(seed, t0=0.0):
    rng = np.random.default_rng(seed)
    return (rng.random((B, S, H, W, 3), np.float32) - 0.5,
            rng.standard_normal((B, 10 * (S - 1) + 1, 6)).astype(np.float32),
            (0.1 * rng.standard_normal((B, S - 1, 6))).astype(np.float32),
            (t0 + np.cumsum(rng.uniform(0.08, 0.13, (B, S)), 1)).astype(np.float32))


def case_spec(name):
    """Two steps, but one for the trained trunk: Adam steps the conv
    biases before its BatchNorms (rounding-noise gradients) by +-lr in
    either run, and the second step's loss would hold that."""
    kind, train, mesh, trunk = CASES[name]
    second = train_batch(11, T0) if kind == "stream" else train_batch(11)
    batches = [train_batch(10)] + ([] if name == "trunk" else [second])
    return {"cfg": configs(**train)[1], "kind": kind, "mesh": mesh, "trunk": trunk,
            "batches": batches, "keys": name == "keys"}


def applied(grads, every):
    """The gradients the updates apply: under accumulation over ``every``
    steps their means (the steps between update nothing)."""
    return [{k: np.mean([g[k] for g in grads[i:i + every]], 0) for k in grads[i]}
            for i in range(0, len(grads), every)]


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def variables():
    jc, _ = configs()
    _, v = init_model(jc, jax.random.PRNGKey(0))
    return randomize_batchnorm(v)


@pytest.fixture(scope="module")
def state_dict(variables):
    return from_jax_variables(variables, tcfg.ModelConfig(**TINY))


def bn_inputs():
    img, imu, _, _ = train_batch(12)
    return img, imu


@pytest.fixture(scope="module")
def world(one_torch_thread, state_dict):  # noqa: F811
    """Both ranks' results of every case (torch_mesh_workers.rank_cases)."""
    cases = {name: case_spec(name) for name in CASES}
    bn_case = {"cfg": configs()[1], "trunk": TRUNK0, "inputs": bn_inputs()}
    return tmesh.launch(workers.rank_cases, ["cpu", "cpu"], state_dict, cases, bn_case)


@pytest.fixture(scope="module")
def split_ckpt(tmp_path_factory):
    """Where the split world's ranks save their checkpoint."""
    return tmp_path_factory.mktemp("split_ckpt")


@pytest.fixture(scope="module")
def split_world(one_torch_thread, state_dict, split_ckpt):  # noqa: F811
    """Every rank's results of torch_mesh_workers.rank_split: the accum2
    case on SPLIT_MESH, its checkpoint under ``split_ckpt``."""
    case = dict(case_spec("accum2"), mesh=SPLIT_MESH)
    return tmesh.launch(workers.rank_split, ["cpu"] * 4, state_dict, case, split_ckpt)


def ranks_of(name, request):
    """The world that ran case ``name`` ("split": the accum2 case over
    SPLIT_MESH with split parameters)."""
    return request.getfixturevalue("split_world" if name == "split" else "world")


@pytest.fixture(scope="module")
def one_process(state_dict):
    """Each case as one process at the global batch: metrics, the trained
    tensors and each step's gradients (not the keys case's: its ranks are
    held against each other, and the one process draws other masks)."""
    out = {}
    for name in (n for n in CASES if n != "keys"):
        case = case_spec(name)
        state = workers.port_state(case, state_dict, "cpu")
        grads = workers.record_grads(state)
        out[name] = {"metrics": workers.run_steps(case, state, "cpu"),
                     **workers.trained(state, grads)}
    return out


@pytest.fixture(scope="module")
def jax_references(variables):
    """``reference(name)``: jax_reference of case ``name``, computed once
    for the accum2 case and the split case, which share it."""
    cache = {}

    def reference(name):
        key = "accum2" if name == "split" else name
        if key not in cache:
            cache[key] = jax_reference(key, variables)
        return cache[key]

    return reference


def jax_reference(name, variables):
    """The JAX package's steps of case ``name`` on a 2-device data mesh;
    the accum2 case's (which the split case shares) on a SPLIT_MESH of 4
    devices, the params put by ``param_sharding_rules`` as JAX's dryrun
    puts them (XLA partitions the same accumulation cycle, so the
    two-rank world is held against it as against a 2-device mesh)."""
    shape = SPLIT_MESH if name == "accum2" else (2, 1)
    kind, train, _, _ = CASES[name]
    jc, _ = configs(**train)
    mesh = jmesh.create_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    tx = jloop.make_optimizer(jc)
    state = jloop.create_train_state(jc, jax.tree_util.tree_map(jnp.asarray, variables), tx,
                                     jax.random.PRNGKey(1))
    # replicated over the mesh as cli.train puts it: the steps then share
    # one compile
    state = jax.device_put(state, jmesh.replicated(mesh))
    if shape[1] > 1:
        state = state.replace(params=jax.tree_util.tree_map(
            jax.device_put, state.params, jmesh.param_sharding_rules(state.params, mesh)))
    # each step's state goes back onto these shardings (the split params come
    # out of a step laid out otherwise), so the steps share one compile
    shardings = jax.tree_util.tree_map(lambda x: x.sharding, state)
    model = jax_create_model(jc)
    if kind == "stream":
        step = jloop.make_streaming_train_step(model, tx, jc)
    else:
        step = jloop.make_train_step(model, tx, jc, carry=kind == "carry")
    metrics, hc = [], None
    for batch in case_spec(name)["batches"]:
        sharded = jmesh.shard_batch(mesh, tuple(map(jnp.asarray, batch)))
        if kind == "stream":
            state, m, hc = step(state, *sharded) if hc is None else step(state, *sharded, hc)
        else:
            state, m = step(state, *sharded)
        state = jax.device_put(state, shardings)
        metrics.append(as_np(m))
    return metrics, as_np(state.params), as_np(state.batch_stats)


def close_where_clear(got, want, grads, rtol, bn_updates=1):
    """tests/test_torch_port_train.py::compare_state's rule on state dicts:
    parameters where every step's gradient clears rounding (exactly 0, or
    above 1e-3 of its tensor's largest, in tensors whose largest is above
    1e-5 of the step's), and every running statistic, a running mean
    after a rounding-noise conv bias within that bias's gap times the
    share the running mean takes in over the ``bn_updates`` updates a step
    makes after the bias moved (1 - 0.9^u: 0.1 for one, 0.19 for the
    carried step's two)."""
    clear = {}
    for g_step in grads:
        top = max(float(np.abs(g).max()) for g in g_step.values())
        for name, g in g_step.items():
            big = float(np.abs(g).max())
            c = ((g == 0) | (np.abs(g) > 1e-3 * big)) & (big > 1e-5 * top)
            clear[name] = c if name not in clear else clear[name] & c
    compared = total = 0
    for name, x in got.items():
        ref = np.asarray(want[name])
        mask = clear.get(name, np.ones(x.shape, bool))
        atol = 1e-6
        if name.endswith("running_mean"):
            base, idx = name[:-len(".running_mean")].rsplit(".", 1)
            bias = f"{base}.{int(idx) - 1}.bias"
            if bias in got:
                atol += ((1 - 0.9 ** bn_updates)
                         * float(np.abs(got[bias] - np.asarray(want[bias])).max()))
        np.testing.assert_allclose(x[mask], ref[mask], rtol=rtol, atol=atol, err_msg=name)
        compared += int(mask.sum())
        total += mask.size
    assert compared > 0.95 * total  # the mask must not hollow out the comparison


def rank0(name, request) -> dict:
    """Rank 0's results of case ``name``."""
    ranks = ranks_of(name, request)
    return ranks[0] if name == "split" else ranks[0][name]


@pytest.mark.parametrize("name", JAX_CASES + ("split",))
def test_two_rank_step_matches_jax_sharded_step(request, jax_references, name):
    """The ranks' steps against JAX's sharded step (accum2: JAX's (2, 2)
    mesh with its params split by the rules; "split": the four ranks with
    split parameters, their gathered tensors, against the same)."""
    ref_metrics, params, stats = jax_references(name)
    got_case = rank0(name, request)
    _, tc = configs(**CASES["accum2" if name == "split" else name][1])
    for got, ref in zip(got_case["metrics"], ref_metrics):
        np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-5)
        for k in ("angle_loss", "trans_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, err_msg=k)
        assert got["solver_incomplete"] == int(ref["solver_incomplete"])
    want = from_jax_variables({"params": params, "batch_stats": stats}, tc.model)
    # the split ranks' gradients are slices: the mask takes the one process's
    grads = request.getfixturevalue("one_process")["accum2"]["grads"] if name == "split" \
        else got_case["grads"]
    close_where_clear(got_case["state"], want,
                      applied(grads, tc.train.grad_accumulation_steps),
                      rtol=1e-4, bn_updates=2 if name == "carry" else 1)


@pytest.mark.parametrize("name", ["fresh", "accum2", "carry", "stream", "trunk", "split"])
def test_two_rank_step_matches_one_process(request, one_process, name):
    """The ranks' steps against the port's one-process step over the
    global batch: the trunk case holds the image trunk's BatchNorm (train
    mode, forward and backward) over the global batch; "split" the four
    ranks with split parameters (their gathered tensors) against accum2's
    one process."""
    ref = one_process["accum2" if name == "split" else name]
    got_case = rank0(name, request)
    for got, want in zip(got_case["metrics"], ref["metrics"]):
        for k in ("loss", "angle_loss", "trans_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert got["solver_incomplete"] == want["solver_incomplete"]
    every = configs(**CASES["accum2" if name == "split" else name][1])[1] \
        .train.grad_accumulation_steps
    close_where_clear(got_case["state"], ref["state"], applied(ref["grads"], every),
                      rtol=1e-5, bn_updates=2 if name == "carry" else 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_one_state(world, name):
    """Model, optimizer, step and generator equal bit for bit on both
    ranks, and so are the metrics each rank reports."""
    assert world[0][name]["digest"] == world[1][name]["digest"]
    assert world[0][name]["metrics"] == world[1][name]["metrics"]


def test_model_axis_ranks_take_the_same_rows(world, one_process):
    """A mesh of one data and two model coordinates: both ranks take every
    row and compute the one-process step, bit for bit."""
    assert [world[r]["model2"]["rows"] for r in (0, 1)] == [0, 0]
    assert world[0]["model2"]["metrics"] == one_process["model2"]["metrics"]
    for k, x in one_process["model2"]["state"].items():
        np.testing.assert_array_equal(world[0]["model2"]["state"][k], x, err_msg=k)


def split_rules():
    """param_sharding_rules over SPLIT_MESH for the tiny model (meta)."""
    with torch.device("meta"):
        model = DeepVIO(configs()[1].model)
    mesh = tmesh.Mesh(dict(zip(("data", "model"), SPLIT_MESH)), {"data": 0, "model": 0},
                      {"data": None, "model": None})
    return model, tmesh.param_sharding_rules(model, mesh)


def test_split_ranks_store_their_slices(split_world):
    """Each of the four ranks stores exactly the slices the rules name:
    a parameter split along its axis into halves, rank (d, m) holding the
    m-th (the gathered tensor's), with Adam moments of the same shape; the
    rest whole. The ranks of one data coordinate hold the same state as a
    checkpoint holds it (gathered), and so do those of the other."""
    model, rules = split_rules()
    split = {n: a for n, a in rules.items() if a is not None}
    assert {"Inertial_net.proj.weight", "Image_net.visual_head.weight"} <= set(split)
    whole = split_world[0]["state_dict"]
    for r in split_world:
        m = r["coords"]["model"]
        for name, p in model.named_parameters():
            want = list(p.shape)
            if name in split:
                want[split[name]] //= SPLIT_MESH[1]
            assert r["shapes"][name] == tuple(want), name
        for name, axis in r["axes"].items():
            assert axis == split.get(name), name
            assert all(s == () or s == r["shapes"][name]
                       for s in r["moment_shapes"][name].values()), name
        assert r["slices"].keys() == {n for n, a in r["axes"].items() if a is not None} != set()
        for name, x in r["slices"].items():
            k = x.shape[split[name]]
            np.testing.assert_array_equal(
                x, np.take(whole[name], np.arange(m * k, (m + 1) * k), axis=split[name]),
                err_msg=name)
    assert len({r["digest"] for r in split_world}) == 1


def test_split_state_dict_round_trips_through_the_bridge(split_world, split_ckpt, state_dict):
    """The gathered state_dict() of the split model has the unsplit layout
    (the keys, order and shapes of the one-process model's): JAX's
    convert_deepvio reads it and the port's from_jax_variables gives it
    back bit for bit; its gathered Adam moments have the parameters'
    whole shapes. The checkpoint the four ranks saved holds that
    state_dict and those moments, and restored into fresh split states it
    gives every rank the state it saved (its digest as a checkpoint holds
    it)."""
    sd = split_world[0]["state_dict"]
    saved = CheckpointManager(split_ckpt).restore_raw("split")
    assert list(saved["model"]) == list(sd)
    for k, x in saved["model"].items():
        np.testing.assert_array_equal(x.numpy(), sd[k], err_msg=k)
    for i, st in enumerate(split_world[0]["moments"]):
        for k, v in st.items():
            np.testing.assert_array_equal(saved["optimizer"]["inner"]["state"][i][k].numpy(), v)
    assert all(r["restored_digest"] == r["digest"] for r in split_world)
    assert list(sd) == list(state_dict)
    assert all(sd[k].shape == tuple(state_dict[k].shape) for k in sd)
    mc = tcfg.ModelConfig(**TINY)
    back = from_jax_variables(convert_deepvio(
        {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}, mc.model_type,
        rnn_num_layers=mc.rnn_num_layers, conv_out_hw=trunk_out_hw(mc.img_h, mc.img_w)), mc)
    assert back.keys() == sd.keys()
    for k, x in back.items():
        np.testing.assert_array_equal(x.numpy(), sd[k], err_msg=k)
    DeepVIO(mc).load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    names = [n for n in split_world[0]["axes"]]
    for name, st in zip(names, split_world[0]["moments"]):
        for k, v in st.items():
            assert v.shape in ((), sd[name].shape), (name, k)


def test_split_clip_norm_counts_each_parameter_once(split_world, one_process):
    """The split step's gradient norm (the clip's and grad_norm, one
    function) sums the slices' squares over the model group and counts
    each replicated gradient once: it equals the one process's at rtol
    1e-5, where counting the replicated gradients on both model ranks
    would move it by more than 1 %."""
    for step, (got, want) in enumerate(zip(split_world[0]["metrics"],
                                            one_process["accum2"]["metrics"])):
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        grads = one_process["accum2"]["grads"][step]
        axes = split_world[0]["axes"]
        rep = sum(float(np.sum(g.astype(np.float64) ** 2)) for n, g in grads.items()
                  if axes[n] is None)
        part = sum(float(np.sum(g.astype(np.float64) ** 2)) for n, g in grads.items()
                   if axes[n] is not None)
        assert part > 0 and abs(np.sqrt(SPLIT_MESH[1] * rep + part) / want["grad_norm"] - 1) > 1e-2


@pytest.mark.slow
def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """dryrun_multichip(4, "cpu"): JAX's dryrun configuration (trunk
    dropout through K3's plain version, the image encoder trained) on four
    gloo ranks of a (2, 2) mesh: every rank the same finite losses, each
    rank's stored parameter and optimizer bytes those of an unsplit rank
    less half of the split ones, and JAX's line after the bytes line."""
    runs = dryrun_multichip(4, "cpu")
    assert [r["coords"] for r in runs] == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    assert all(r["metrics"] == runs[0]["metrics"] for r in runs)
    assert all(np.isfinite(m["loss"]) for m in runs[0]["metrics"])
    with torch.device("meta"):
        whole = sum(p.numel() * p.element_size()
                    for p in DeepVIO(dryrun_config(4)[0].model).parameters())
    for r in runs:
        b = r["stored_bytes"]
        assert b["params_split"] > 0 and b["optimizer_split"] > 0
        assert b["params"] + b["params_split"] == b["params_unsplit"] == whole
        assert b["optimizer"] + b["optimizer_split"] == b["optimizer_unsplit"]
    assert runs[0]["state"]["Image_net.visual_head.weight"].shape == (128, 2048)
    out = capsys.readouterr().out.splitlines()
    loss = runs[0]["metrics"][-1]["loss"]
    assert out[-1] == f"dryrun_multichip ok: mesh={{'data': 2, 'model': 2}} loss={loss:.4f}"
    assert '"dryrun_multichip_stored_bytes"' in out[-2]


def test_rank_keys_differ_from_one_generator(world):
    """With trunk dropout the two ranks mix different keys out of one
    generator, which stays equal on both (test_ranks_hold_one_state);
    coordinate 0 keeps the generator's own key."""
    assert world[0]["keys"]["key"] != world[1]["keys"]["key"]
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    plain = draw_key(gen)
    gen.set_state(state)
    assert draw_key(RankKeys(gen, 0)) == plain == mix_key(plain, 0)
    assert mix_key(plain, 1) != plain


def encode_once(state_dict, order):
    """One process's train-mode encoders (trunk at dropout rate 0) on the
    global batch with its rows in ``order``: features back in row order,
    and the running statistics."""
    cfg = configs()[1]
    model = DeepVIO(cfg.model)
    model.Image_net = ImageEncoder(cfg.model, TRUNK0)
    model.load_state_dict(state_dict, strict=True)
    model.train()
    img, imu = (torch.as_tensor(x[order]) for x in bn_inputs())
    with torch.no_grad():
        feats = model.encode(img, imu, torch.Generator().manual_seed(0))
    back = np.argsort(order)
    return ([f.numpy()[back] for f in feats],
            {k: v.numpy() for k, v in model.state_dict().items() if "running" in k})


def test_global_batchnorm_statistics(world, state_dict):
    """Encoders in train mode on each rank's rows with the statistics over
    the global batch, against one process on the global batch. The two sum
    each channel in another order, so the limit is 4x how far rounding
    alone moves the one process's result: the same batch with its rows in
    reverse order (which sums the statistics in another order), measured
    here; the ranks' statistics equal bit for bit."""
    (fv, fi), stats = encode_once(state_dict, np.arange(B))
    (rv, ri), rstats = encode_once(state_dict, np.arange(B)[::-1])
    got = [world[r]["bn"] for r in (0, 1)]
    for name, x, want, reach in (("fv", np.concatenate([g["fv"] for g in got]), fv, rv),
                                 ("fi", np.concatenate([g["fi"] for g in got]), fi, ri)):
        limit = 4 * float(np.abs(reach - want).max())
        assert 0 < limit < 1e-4 * float(np.abs(want).max()), name
        np.testing.assert_allclose(x, want, rtol=0, atol=limit, err_msg=name)
    for k, v in stats.items():
        np.testing.assert_array_equal(got[0]["stats"][k], got[1]["stats"][k], err_msg=k)
        limit = 4 * float(np.abs(rstats[k] - v).max()) + 1e-7
        np.testing.assert_allclose(got[0]["stats"][k], v, rtol=0, atol=limit, err_msg=k)


# ---------------------------------------------------------------------------
# eval and serving lanes over replicas
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_kitti_tree(tmp_path_factory.mktemp("mesh") / "kitti", seqs=("05", "07"),
                           n_frames=24, img_hw=(32, 64), speed_scale=50.0)


def eval_model(fuse_method, model_type="ode-rnn"):
    cde = dict(cde_hidden_dim=16) if model_type == "cde" else {}
    cfg = tcfg.Config(model=tcfg.ModelConfig(**dict(TINY, img_h=32, img_w=64, seq_len=4,
                                                   fuse_method=fuse_method,
                                                   model_type=model_type, **cde)))
    return create_model(cfg, seed=3, device="cpu")


def test_cde_solve_rows_are_independent():
    """The cde core's adaptive solve in float64: each row of a batch of 4
    alone gives its row of the batch bit for bit, step counts too. No
    row reaches another's result; in float32 a batch of 4 rounds the
    field otherwise than a batch of 1, and the step controller turns that
    into another step sequence."""
    from ode_vio_tpu_torch.ops.interpolation import cdeint_batched
    from ode_vio_tpu_torch.ops.solvers.odeint import SolverOptions

    gen = torch.Generator().manual_seed(0)
    h, c, rows, knots = 8, 5, 4, 4
    w1 = 0.5 * torch.randn(h, 16, generator=gen, dtype=torch.float64)
    w2 = 0.5 * torch.randn(16, h * c, generator=gen, dtype=torch.float64)
    z0 = torch.randn(rows, h, generator=gen, dtype=torch.float64)
    ts = torch.cumsum(0.08 + 0.05 * torch.rand(rows, knots, generator=gen,
                                               dtype=torch.float64), 1)
    xs = torch.randn(rows, knots, c, generator=gen, dtype=torch.float64)
    opts = SolverOptions(rtol=1e-4, atol=1e-6, dt0=1e-4)

    def solve(r):
        return cdeint_batched(lambda z: torch.tanh(torch.tanh(z @ w1) @ w2).reshape(-1, h, c),
                              z0[r], ts[r], xs[r], ts[r], "linear", opts)

    zs, stats = solve(slice(None))
    for r in range(rows):
        z, st = solve(slice(r, r + 1))
        assert torch.equal(z, zs[r:r + 1])
        assert torch.equal(st.accepted, stats.accepted[r:r + 1])


@pytest.mark.parametrize("case", ["soft", "hard", "cde"])
def test_split_eval_equals_unsplit(tree, case):
    """Two runs of both sequences at eval dropout 0.3 (4 lanes) through
    eval_runs over devices=[cpu, cpu] (two replicas, two lanes each, hard
    fusion's noise drawn for all four lanes and sliced), against unsplit:
    each lane's trajectory at atol 1e-5; the replicas' truncated solves
    counted on the callable. The cde core is held against each replica's
    lanes (one run) unsplit in calls of their own, which compute what the
    replica computes: its adaptive solve makes another step sequence out
    of the rounding of another batch (test_cde_solve_rows_are_independent)."""
    model = eval_model("soft" if case == "cde" else case,
                       "cde" if case == "cde" else "ode-rnn")

    def run(runs, devices):
        infer = make_infer_fn(model, fold_bn=True, device="cpu")
        evs = [KittiEvaluator(tree, ("05", "07"), 4, (32, 64), 0.3,
                              rng=np.random.default_rng(run)) for run in runs]
        eval_runs(infer, evs, devices=devices)
        return [np.asarray(r["est_global"]) for ev in evs for r in ev.results], infer.incomplete()

    split = run(range(2), ["cpu", "cpu"])
    if case == "cde":
        parts = [run((r,), None) for r in range(2)]
        ref = ([x for p in parts for x in p[0]], sum(p[1] for p in parts))
    else:
        ref = run(range(2), None)
    assert len(split[0]) == len(ref[0]) == 4
    for a, b in zip(ref[0], split[0]):
        np.testing.assert_allclose(b, a, atol=1e-5)
    assert ref[1] == split[1]


def test_engine_over_replicas_equals_one_device(tree):
    """StreamingEngine(max_sessions=4) over two CPU replicas against one
    device, hard fusion, sessions opening late and one idling: every
    session's poses and hidden state at atol 1e-5."""
    model = eval_model("hard")
    rng = np.random.default_rng(4)

    def window(t0):
        return (rng.random((4, 32, 64, 3), np.float32) - 0.5,
                rng.standard_normal((31, 6)).astype(np.float32),
                (t0 + np.cumsum(rng.uniform(0.08, 0.13, 4))).astype(np.float32))

    schedule = [([0, 1], [0, 1]), ([2, 3], [0, 2, 3]), ([], [1, 2, 3])]
    wins = [{s: window(0.5 * w) for s in served} for w, (_, served) in enumerate(schedule)]
    results = []
    for devices in (None, ["cpu", "cpu"]):
        eng = StreamingEngine(model, max_sessions=4, device="cpu", devices=devices)
        poses = []
        for (opens, _), batch in zip(schedule, wins):
            for _ in opens:
                eng.open_session()
            poses.append(eng.step(batch))
        results.append((poses, [eng.hidden(s) for s in range(4)]))
    for a, b in zip(results[0][0], results[1][0]):
        assert a.keys() == b.keys()
        for s in a:
            np.testing.assert_allclose(b[s], a[s], atol=1e-5)
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


def test_engine_sessions_must_split_over_devices():
    with pytest.raises(ValueError, match="does not split over 2 devices"):
        StreamingEngine(eval_model("soft"), max_sessions=3, device="cpu",
                        devices=["cpu", "cpu"])


# ---------------------------------------------------------------------------
# the rules of the mesh against JAX's
# ---------------------------------------------------------------------------

def flagship_model():
    return dict(model_type="ode-rnn", ode_activation_fn="softplus", ode_fn_num_layers=2,
                ode_hidden_dim=1024, rnn_num_layers=3, fuse_method="soft")


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_param_sharding_rules_match_jax(which):
    """Over a model axis of 2, for each parameter: sharded where JAX's
    rule shards the leaf it comes from, along the axis of the same length
    (shapes only: JAX's tree from eval_shape, the port's model on meta;
    the leaf of each parameter found through the weight bridge, each JAX
    leaf filled with its own index)."""
    fields = TINY if which == "tiny" else flagship_model()
    jc = jcfg.Config(model=jcfg.ModelConfig(**fields),
                     data=jcfg.DataConfig(seq_len=jcfg.ModelConfig(**fields).seq_len))
    shapes = jax.eval_shape(lambda k: init_model(jc, k)[1], jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    jax_mesh = jmesh.create_mesh(4, 2, devices=jax.devices()[:8])
    specs = jax.tree_util.tree_leaves(jmesh.param_sharding_rules(
        jax.tree_util.tree_unflatten(treedef, leaves), jax_mesh))
    filled = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    sd = from_jax_variables(filled, tcfg.ModelConfig(**fields))
    with torch.device("meta"):
        model = DeepVIO(tcfg.ModelConfig(**fields))
    mesh = tmesh.Mesh({"data": 4, "model": 2}, {"data": 0, "model": 0},
                      {"data": None, "model": None})
    rules = tmesh.param_sharding_rules(model, mesh)
    assert rules.keys() == dict(model.named_parameters()).keys()
    n_split = 0
    for name, axis in rules.items():
        x = sd[name]
        assert x.min() == x.max(), name  # one JAX leaf
        leaf, spec = leaves[int(x.min())], specs[int(x.min())].spec
        if spec == jax.sharding.PartitionSpec(None, "model"):
            assert axis is not None and model.get_parameter(name).shape[axis] == leaf.shape[-1]
            n_split += 1
        else:
            assert axis is None, name
    assert n_split > 0


@pytest.mark.parametrize("batch,want", [(4, 4), (16, 8), (6, 2), (7, 1)])
def test_auto_data_axis_matches_jax(batch, want):
    """JAX's cases (tests/test_misc_api.py), 8 devices."""
    assert jmesh.auto_data_axis(batch, 1) == want
    assert tmesh.auto_data_axis(batch, 1, ["cpu"] * 8) == want


def test_mesh_shape_errors_match_jax():
    with pytest.raises(ValueError) as ref:
        jmesh.create_mesh(3, 2, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        tmesh.create_mesh(3, 2, devices=["cpu"] * 8)
    assert str(got.value) == str(ref.value)


def test_one_device_mesh_has_no_process_group():
    """world = 1: no process group and no collective; the step's keys are
    the generator itself and the mesh's rows are the whole batch."""
    mesh = tmesh.create_mesh(-1, 1)
    assert not torch.distributed.is_initialized()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {"data": None, "model": None}
    assert tmesh.batch_rows(mesh, 6) == slice(0, 6)


# ---------------------------------------------------------------------------
# the training command line
# ---------------------------------------------------------------------------

TRAIN_FLAGS = [
    "--img_w", "64", "--img_h", "32", "--seq_len", "4", "--v_f_len", "32", "--i_f_len", "16",
    "--ode_hidden_dim", "16", "--rnn_num_layers", "2", "--ode_max_steps", "8",
    "--compute_dtype", "float32", "--batch_size", "4", "--train_seq", "05", "--val_seq", "07",
    "--epochs_joint", "0", "--epochs_fine", "0", "--workers", "0", "--print_frequency", "2",
    "--freeze_encoder", "--ckpt_every", "1", "--device", "cpu",
]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_train_two_ranks_then_multihost_resume(tree, tmp_path):
    """``cli.train --device cpu --mesh_data 2``: this process starts two
    ranks, which train two epochs (trunk dropout through K3's plain
    version, so each rank's keys matter) and evaluate on rank 0. Then a
    job of two processes started by hand with torchrun's variables
    (``--multihost``, the mesh over its two ranks) resumes from the run's
    epoch 0, as a run stopped there would; its epoch_001 equals the
    unbroken run's bit for bit, and each of its ranks logged to its own
    file."""
    from test_torch_port_train_cli import assert_same

    flags = ["--data_dir", str(tree), *TRAIN_FLAGS, "--mesh_data", "2"]
    timing = {}
    train_main(["--save_dir", str(tmp_path / "cont"), "--experiment_name", "run", *flags,
                "--epochs_warmup", "2"], timing)
    assert len(timing["ranks"]) == 2 and len(timing["epochs"]) == 2
    assert timing["ranks"][1]["epochs"][0]["t_rel"] == timing["epochs"][0]["t_rel"]
    assert timing["ranks"][1]["epochs"][0]["eval_timing"] is None
    # the run stopped after epoch 0: its checkpoints directory up to there
    cont = tmp_path / "cont" / "run" / "checkpoints"
    split = tmp_path / "split" / "run" / "checkpoints"
    shutil.copytree(cont / "epoch_000", split / "epoch_000")
    shutil.copy(cont / "epoch_000.meta.json", split)
    port = free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ode_vio_tpu_torch.cli.train", "--save_dir",
             str(tmp_path / "split"), "--experiment_name", "run", *flags,
             "--epochs_warmup", "2", "--pretrain", str(split), "--multihost"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    a, b = CheckpointManager(cont), CheckpointManager(split)
    assert_same(b.restore_raw("epoch_001"), a.restore_raw("epoch_001"))
    logs = sorted(p.name for p in (tmp_path / "split" / "run" / "logs").iterdir())
    assert logs == ["train_run.log", "train_run_rank1.log"]
