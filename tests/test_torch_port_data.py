"""The port's data layer against the JAX package's: geometry, sequence
loading, frame dropout, the synthetic KITTI writer, the native decoder and
its prefetcher, transforms, datasets, samplers and the prefetching loader.
These are numpy on the host in both packages, so every comparison is
exact (array_equal), not within a tolerance."""

from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

from ode_vio_tpu.data import kitti as jk
from ode_vio_tpu.data import loader as jl
from ode_vio_tpu.data import native_loader as jnl
from ode_vio_tpu.data import synthetic as jsyn
from ode_vio_tpu.data import transforms as jt
from ode_vio_tpu.utils import geometry as jgeo
from ode_vio_tpu_torch.data import kitti as tk
from ode_vio_tpu_torch.data import loader as tl
from ode_vio_tpu_torch.data import native_loader as tnl
from ode_vio_tpu_torch.data import synthetic as tsyn
from ode_vio_tpu_torch.data import transforms as tt
from ode_vio_tpu_torch.utils import geometry as tgeo

HW = (32, 64)


def assert_same(a, b):
    """Equal values and structure: arrays bit for bit, lists and tuples
    element by element, scalars exactly."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def rand_pose(rng, n=None):
    shape = (6,) if n is None else (n, 6)
    p = rng.standard_normal(shape)
    p[..., :3] *= 0.3
    return p


def rand_mat(rng):
    return jgeo.pose6dof_to_matrix(rand_pose(rng))


# case -> (function, its arguments from a numpy generator)
GEOMETRY_CASES = {
    "is_rotation_matrix": ("is_rotation_matrix", lambda r: (rand_mat(r)[:3, :3],)),
    "euler_to_matrix": ("euler_to_matrix", lambda r: (rand_pose(r)[:3],)),
    "matrix_to_euler": ("matrix_to_euler", lambda r: (rand_mat(r),)),
    # the two gimbal-lock branches (pitch -90 and +90 deg)
    "matrix_to_euler_pitch_down": (
        "matrix_to_euler", lambda r: (jgeo.euler_to_matrix([0.3, -np.pi / 2, 0.2]),)),
    "matrix_to_euler_pitch_up": (
        "matrix_to_euler", lambda r: (jgeo.euler_to_matrix([0.3, np.pi / 2, 0.2]),)),
    "normalize_angle": ("normalize_angle", lambda r: (float(r.uniform(-10, 10)),)),
    "pose6dof_to_matrix": ("pose6dof_to_matrix", lambda r: (rand_pose(r),)),
    "matrix_to_pose6dof": ("matrix_to_pose6dof", lambda r: (rand_mat(r),)),
    "relative_pose": ("relative_pose", lambda r: (rand_mat(r), rand_mat(r))),
    "relative_pose6dof": ("relative_pose6dof", lambda r: (rand_mat(r), rand_mat(r))),
    "compose_pose_changes": ("compose_pose_changes", lambda r: (rand_pose(r), rand_pose(r))),
    "accumulate_path": ("accumulate_path", lambda r: (rand_pose(r, 7),)),
    "rotation_error": ("rotation_error", lambda r: (rand_mat(r), rand_mat(r))),
    "translation_error": ("translation_error", lambda r: (rand_mat(r), rand_mat(r))),
    "rmse_6dof": ("rmse_6dof", lambda r: (rand_pose(r, 9), rand_pose(r, 9))),
    "trajectory_distances": (
        "trajectory_distances", lambda r: (jgeo.accumulate_path(rand_pose(r, 12)),)),
    "last_frame_from_segment_length": (
        "last_frame_from_segment_length", lambda r: (np.cumsum(r.uniform(0, 2, 40)), 3, 10.0)),
    "last_frame_from_segment_length_none": (
        "last_frame_from_segment_length", lambda r: (np.cumsum(r.uniform(0, 2, 40)), 3, 1e3)),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_equal(case):
    name, make_args = GEOMETRY_CASES[case]
    args = make_args(np.random.default_rng(len(case)))
    assert_same(getattr(tgeo, name)(*args), getattr(jgeo, name)(*args))


def test_pose_and_time_files_equal(tmp_path):
    rng = np.random.default_rng(0)
    poses = jgeo.accumulate_path(rand_pose(rng, 6))
    tgeo.save_trajectory(poses, tmp_path / "t.txt")
    jgeo.save_trajectory(poses, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert_same(tgeo.read_pose_file(tmp_path / "t.txt"), jgeo.read_pose_file(tmp_path / "t.txt"))
    np.savetxt(tmp_path / "times.txt", np.cumsum(rng.uniform(0.05, 0.15, 8)))
    assert_same(tgeo.read_time_file(tmp_path / "times.txt"),
                jgeo.read_time_file(tmp_path / "times.txt"))
    np.savetxt(tmp_path / "bad.txt", [0.0, 0.2, 0.1])
    for geo in (tgeo, jgeo):
        with pytest.raises(ValueError, match="not strictly ascending"):
            geo.read_time_file(tmp_path / "bad.txt")


# ---------------------------------------------------------------------------
# The synthetic tree, written by both packages from one seed
# ---------------------------------------------------------------------------

TREES = {
    "noise": dict(seqs=("00", "05"), n_frames=14, img_hw=HW, seed=3),
    "odometric_jitter": dict(seqs=("07",), n_frames=9, img_hw=(20, 36), seed=5,
                             jitter=0.3, speed_scale=4.0, imu_mode="odometric"),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, kw in TREES.items():
        base = tmp_path_factory.mktemp(f"tree_{name}")
        out[name] = (tsyn.make_kitti_tree(base / "port", **kw),
                     jsyn.make_kitti_tree(base / "jax", **kw))
    return out


@pytest.mark.parametrize("tree", sorted(TREES))
def test_synthetic_tree_equal(trees, tree):
    """Same poses, times and IMU files; PNGs that decode to the same
    pixels (the port writes them with zlib, the JAX package with PIL)."""
    port, jax_root = trees[tree]
    for seq in TREES[tree]["seqs"]:
        for rel in (f"poses/{seq}.txt", f"sequences/{seq}/times.txt"):
            assert (port / rel).read_bytes() == (jax_root / rel).read_bytes(), rel
        assert_same(sio.loadmat(port / f"imus/{seq}.mat")["imu_data_interp"],
                    sio.loadmat(jax_root / f"imus/{seq}.mat")["imu_data_interp"])
        pngs = sorted((port / f"sequences/{seq}/image_2").glob("*.png"))
        ref = sorted((jax_root / f"sequences/{seq}/image_2").glob("*.png"))
        assert [p.name for p in pngs] == [p.name for p in ref]
        for a, b in zip(pngs, ref):
            assert_same(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


@pytest.fixture(scope="module")
def root(trees):
    return trees["noise"][0]


def test_load_sequence_equal(root):
    t, j = tk.load_sequence(root, "05"), jk.load_sequence(root, "05")
    assert t.folder == j.folder and t.num_frames == j.num_frames
    assert_same([t.img_paths, t.abs_poses, t.rel_poses, t.timestamps, t.imus],
                [j.img_paths, j.abs_poses, j.rel_poses, j.timestamps, j.imus])


@pytest.mark.parametrize("dropout", [0.0, 0.3, 0.7])
def test_inject_frame_dropout_equal(root, dropout):
    seq = jk.load_sequence(root, "00")
    t = tk.inject_frame_dropout(tk.load_sequence(root, "00"), dropout,
                                np.random.default_rng(11))
    j = jk.inject_frame_dropout(seq, dropout, np.random.default_rng(11))
    assert_same([t.img_paths, t.abs_poses, t.rel_poses, t.timestamps, t.imus],
                [j.img_paths, j.abs_poses, j.rel_poses, j.timestamps, j.imus])
    if dropout > 0.5:
        assert t.num_frames < seq.num_frames


@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_kitti_dataset_equal(root, dropout):
    kw = dict(sequence_length=4, train_seqs=["00", "05"], dropout=dropout)
    t = tk.KittiDataset(root, rng=np.random.default_rng(2), **kw)
    j = jk.KittiDataset(root, rng=np.random.default_rng(2), **kw)
    assert len(t) == len(j) and t.seq_num_windows == j.seq_num_windows
    for a, b in zip(t.samples, j.samples):
        assert a.folder == b.folder and a.rot == b.rot
        assert_same([a.img_paths, a.imus, a.gts, a.timestamps],
                    [b.img_paths, b.imus, b.gts, b.timestamps])
    assert_same(t[3], j[3])
    assert_same(tk.collate([t[0], t[1]]), jk.collate([j[0], j[1]]))


def test_samplers_equal():
    for shuffle, drop_last in ((True, False), (False, True)):
        t = tk.BoundarySafeBatchSampler(23, 4, shuffle=shuffle, seed=7, drop_last=drop_last)
        j = jk.BoundarySafeBatchSampler(23, 4, shuffle=shuffle, seed=7, drop_last=drop_last)
        assert len(t) == len(j)
        assert [list(t), list(t)] == [list(j), list(j)]  # two epochs: reshuffled alike
    t = tk.StreamingChainSampler([20, 13], 2, chain_len=3, stride=3, seed=4)
    j = jk.StreamingChainSampler([20, 13], 2, chain_len=3, stride=3, seed=4)
    assert len(t) == len(j) and t.chunks == j.chunks
    assert [list(t), list(t)] == [list(j), list(j)]


# ---------------------------------------------------------------------------
# Native decode and prefetch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pngs(root):
    if not (tnl.is_available() and jnl.is_available()):
        pytest.fail(f"native build failed: port {tnl.build_error()} jax {jnl.build_error()}")
    return sorted((root / "sequences/05/image_2").glob("*.png"))


def test_native_library_is_the_ports_own():
    """The port builds its own copy of the decoder into its own _build
    directory, named by the hash of its source."""
    lib = tnl.library_path()
    pkg = Path(tnl.__file__).resolve().parent.parent
    assert lib.parent == pkg / "_build" and lib.name.startswith("libvioio-")
    assert tnl.is_available() and lib.exists(), tnl.build_error()


@pytest.mark.parametrize("out_hw,threads", [(HW, 1), ((16, 40), 3), ((48, 80), 2)])
def test_decode_batch_equal(pngs, out_hw, threads):
    """Same size, an antialiased downscale and an upscale."""
    assert_same(tnl.decode_batch(pngs, out_hw, threads=threads),
                jnl.decode_batch(pngs, out_hw, threads=threads))


def test_decode_fallback_equal(pngs, monkeypatch):
    """Without the native library both packages decode with PIL."""
    monkeypatch.setattr(tnl, "_get_lib", lambda: None)
    monkeypatch.setattr(jnl, "_get_lib", lambda: None)
    assert_same(tnl.decode_batch(pngs[:3], (16, 40)), jnl.decode_batch(pngs[:3], (16, 40)))
    pf = tnl.Prefetcher(HW)
    pf.submit(4, pngs[:2])
    assert_same(pf.get(4), jk.load_images(pngs[:2], size_hw=HW))


def test_decode_missing_file_raises(pngs, tmp_path):
    with pytest.raises(IOError):
        tnl.decode_batch([tmp_path / "nope.png"], (8, 8))


def test_prefetcher_tickets(pngs):
    """Overlapped tickets retrieved out of order, each equal to a direct
    decode of its paths in both packages."""
    results = []
    for nl in (tnl, jnl):
        pf = nl.Prefetcher(HW, threads=2)
        try:
            pf.submit(10, pngs[:3])
            pf.submit(11, pngs[3:7])
            pf.submit(12, pngs[7:8])
            got = {11: pf.get(11), 10: pf.get(10), 12: pf.get(12)}
        finally:
            pf.close()
        results.append(got)
    direct = tnl.decode_batch(pngs[:8], HW)
    for ticket, sl in ((10, slice(0, 3)), (11, slice(3, 7)), (12, slice(7, 8))):
        assert_same(results[0][ticket], direct[sl])
        assert_same(results[0][ticket], results[1][ticket])


# ---------------------------------------------------------------------------
# Transforms and the prefetching loader
# ---------------------------------------------------------------------------

def sample(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((4, 24, 40, 3), np.float32) - 0.5,
            rng.standard_normal((31, 6)).astype(np.float32),
            rng.standard_normal((3, 6)).astype(np.float32),
            np.cumsum(rng.uniform(0.05, 0.15, 4)).astype(np.float32))


TRANSFORMS = {
    "center": lambda m, rng: m.Center(),
    "resize": lambda m, rng: m.Resize((16, 32)),
    "hflip": lambda m, rng: m.RandomHorizontalFlip(p=0.5, rng=rng),
    "color": lambda m, rng: m.RandomColorAug(p=0.5, rng=rng),
    "normalize": lambda m, rng: m.Normalize(),
    "pipeline": lambda m, rng: m.get_transforms((16, 32), hflip=True, color=True,
                                                normalize=True, rng=rng),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_equal(name):
    """Same outputs over several draws of the same numpy generator."""
    t = TRANSFORMS[name](tt, np.random.default_rng(9))
    j = TRANSFORMS[name](jt, np.random.default_rng(9))
    for k in range(6):
        s = sample(k)
        assert_same(t(*[a.copy() for a in s]), j(*[a.copy() for a in s]))


@pytest.mark.parametrize("augment", [False, True])
def test_prefetching_loader_equal(root, augment):
    batches = []
    for kitti, loader, transforms in ((tk, tl, tt), (jk, jl, jt)):
        ds = kitti.KittiDataset(root, sequence_length=3, train_seqs=["00"])
        sampler = kitti.BoundarySafeBatchSampler(len(ds), 3, seed=1)
        transform = (transforms.get_transforms(HW, hflip=True, color=True, normalize=True,
                                               rng=np.random.default_rng(5), base=False)
                     if augment else None)
        batches.append(list(loader.PrefetchingLoader(ds, sampler, HW, transform=transform)))
    assert len(batches[0]) == len(batches[1]) > 1
    assert_same(batches[0], batches[1])
