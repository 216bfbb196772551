"""KITTI odometry dataset: sequence loading, frame-dropout irregularity,
fixed-shape windowing and boundary-safe batch sampling (host-side numpy).

The port's copy of ``ode_vio_tpu/data/kitti.py`` (the reference's
``src/data/KITTI_dataset.py:20-214``), with the same numpy random draws,
so a dropout-injected sequence is the same in both packages. All
irregularity (random frame deletion) happens on the host when the
dataset is built, so every device batch keeps the static shapes
``img (B,S,H,W,3) / imu (B,10(S-1)+1,6) / gt (B,S-1,6) / ts (B,S)``.

Frame-dropout semantics: each droppable interior frame is deleted with
probability ``dropout``; the two relative poses meeting at the dropped
frame compose into one (KITTI_dataset.py:63-74). Unlike the reference —
which composes the poses of frame ``i+1`` but deletes image/timestamp
``i`` (an off-by-one; the streams drift around dropped frames) — this
implementation deletes image/timestamp/abs-pose/IMU rows of the *same*
frame whose poses were composed, keeping all streams aligned. The
10-IMU-rows-per-interval invariant is preserved by dropping the deleted
frame's interval rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from ode_vio_tpu_torch.utils import geometry as geo

IMU_FREQ = 10


@dataclass
class SequenceData:
    """One KITTI sequence, streams index-aligned: frame k has image
    ``img_paths[k]``, absolute pose ``abs_poses[k]``, timestamp
    ``timestamps[k]``; ``rel_poses[k]`` maps frame k -> k+1; IMU rows
    ``[k*10, (k+1)*10)`` cover interval k (plus one trailing row)."""

    folder: str
    img_paths: List[Path]
    abs_poses: np.ndarray    # (N, 4, 4)
    rel_poses: np.ndarray    # (N-1, 6)
    timestamps: np.ndarray   # (N,)
    imus: np.ndarray         # (>= 10*(N-1)+1, 6)

    @property
    def num_frames(self) -> int:
        return len(self.img_paths)


def load_sequence(data_dir, folder: str) -> SequenceData:
    """Read poses/times/imu/.png paths for one sequence
    (KITTI_dataset.py:43-61)."""
    root = Path(data_dir)
    abs_poses, rel_poses = geo.read_pose_file(root / "poses" / f"{folder}.txt")
    timestamps = geo.read_time_file(root / "sequences" / folder / "times.txt")
    imus = _load_imu_mat(root / "imus" / f"{folder}.mat")
    img_paths = sorted((root / "sequences" / folder / "image_2").glob("*.png"))
    return SequenceData(folder, img_paths, abs_poses, rel_poses,
                        np.asarray(timestamps, np.float64), imus)


def _load_imu_mat(path) -> np.ndarray:
    import scipy.io as sio

    return np.asarray(sio.loadmat(path)["imu_data_interp"], np.float64)


def inject_frame_dropout(
    seq: SequenceData, dropout: float, rng: np.random.Generator
) -> SequenceData:
    """Randomly delete interior frames with probability ``dropout``,
    composing the adjoining relative poses — the irregular-sampling
    augmentation (KITTI_dataset.py:63-74, KITTI_eval.py:59-70).

    Invariant: the absolute pose of every surviving frame, reconstructed by
    accumulating the surviving relative poses, is unchanged (tested).
    """
    if dropout <= 0.0:
        return seq
    rel = list(seq.rel_poses)
    keep = list(range(seq.num_frames))
    # walk rel-pose index i; dropping frame i+1 composes rel[i] o rel[i+1].
    i = 1
    while i < len(rel) - 2:
        if rng.random() < dropout:
            rel[i] = geo.compose_pose_changes(rel[i], rel[i + 1])
            del rel[i + 1]
            del keep[i + 1]
        else:
            i += 1
    keep_arr = np.asarray(keep)
    # IMU: keep interval rows of surviving intervals; interval k of the new
    # stream is [old-frame keep[k] .. keep[k+1]) and keeps the 10 rows of
    # the *leading* old interval, preserving 10 rows/interval.
    imu_rows = [
        np.arange(k * IMU_FREQ, (k + 1) * IMU_FREQ) for k in keep_arr[:-1]
    ]
    imu_rows.append(np.asarray([keep_arr[-1] * IMU_FREQ]))
    return SequenceData(
        folder=seq.folder,
        img_paths=[seq.img_paths[k] for k in keep],
        abs_poses=seq.abs_poses[keep_arr],
        rel_poses=np.asarray(rel),
        timestamps=seq.timestamps[keep_arr],
        imus=seq.imus[np.concatenate(imu_rows)],
    )


@dataclass
class Window:
    """One training sample: ``seq_len`` frames of one sequence."""

    img_paths: List[Path]
    imus: np.ndarray         # (10*(S-1)+1, 6)
    gts: np.ndarray          # (S-1, 6) relative poses
    timestamps: np.ndarray   # (S,)
    rot: float               # window rotation magnitude (KITTI_dataset.py:98)
    folder: str


class KittiDataset:
    """Sliding overlapping windows over dropout-injected sequences
    (KITTI_dataset.py:77-138)."""

    def __init__(
        self,
        data_dir,
        sequence_length: int = 11,
        train_seqs: Sequence[str] = ("00", "01", "02", "04", "06", "08", "09"),
        transform: Optional[Callable] = None,
        dropout: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.sequence_length = sequence_length
        self.transform = transform
        self.train_seqs = list(train_seqs)
        rng = rng or np.random.default_rng()
        self.samples: List[Window] = []
        self.seq_num_windows: List[int] = []
        for folder in self.train_seqs:
            seq = inject_frame_dropout(load_sequence(data_dir, folder), dropout, rng)
            n = 0
            S = sequence_length
            for i in range(0, seq.num_frames - S):
                if not np.all(np.diff(seq.timestamps[i : i + S]) > 0):
                    raise ValueError("timestamps not strictly ascending")
                self.samples.append(
                    Window(
                        img_paths=seq.img_paths[i : i + S],
                        imus=seq.imus[i * IMU_FREQ : (i + S - 1) * IMU_FREQ + 1],
                        gts=np.asarray(seq.rel_poses[i : i + S - 1], np.float32),
                        timestamps=np.asarray(seq.timestamps[i : i + S], np.float32),
                        rot=geo.rotation_error(
                            seq.abs_poses[i], seq.abs_poses[i + S - 1]
                        ),
                        folder=folder,
                    )
                )
                n += 1
            self.seq_num_windows.append(n)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        """Returns (imgs (S,H,W,3) f32, imus, gts, ts) after transforms."""
        w = self.samples[index]
        imgs = load_images(w.img_paths)
        imus = np.array(w.imus, np.float32)
        gts = np.array(w.gts, np.float32)
        ts = np.array(w.timestamps, np.float32)
        if self.transform is not None:
            imgs, imus, gts, ts = self.transform(imgs, imus, gts, ts)
        if not np.all(np.diff(ts) > 0):
            raise ValueError("timestamps must be strictly ascending")
        return imgs, imus, gts, ts


def load_images(paths: Sequence[Path], size_hw=None) -> np.ndarray:
    """Decode PNGs into a stacked float32 NHWC array in [0, 1]."""
    from PIL import Image

    out = []
    for p in paths:
        im = Image.open(p)
        if size_hw is not None:
            im = im.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
        out.append(np.asarray(im, np.float32) / 255.0)
    return np.stack(out, 0)


class BoundarySafeBatchSampler:
    """Epoch-shuffled batches of window indices. Windows are built
    per-sequence, so no batch ever straddles a sequence boundary — the
    guarantee the reference's SequenceBoundarySampler provides
    (KITTI_dataset.py:161-214). Reshuffles on every iteration pass."""

    def __init__(self, num_samples: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        idx = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (
            self.num_samples - self.num_samples % self.batch_size
            if self.drop_last
            else self.num_samples
        )
        for i in range(0, end, self.batch_size):
            yield idx[i : i + self.batch_size].tolist()

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)


def collate(batch_items) -> tuple:
    """Stack per-sample tuples into batched arrays."""
    cols = list(zip(*batch_items))
    return tuple(np.stack(c, 0) for c in cols)


class StreamingChainSampler:
    """Sequence-ordered chains of boundary-sharing windows for
    full-sequence TBPTT training (training/loop.py::
    make_streaming_train_step).

    The standard sampler shuffles overlapping stride-1 windows — every
    window trains fresh. Streaming eval instead walks stride-(S-1)
    windows that share one boundary frame, carrying hidden state across
    them (KITTI_eval.py:78-91, 141; data/evaluation.py::EvalPartition).
    This sampler reproduces that layout at train time: from the stride-1
    window list it selects, per sequence and per phase offset in
    ``range(stride)``, the chain ``offset, offset+stride, ...`` —
    consecutive chain windows are exactly the eval partition's
    continuation windows.

    Chains are cut into synchronized chunks of ``chain_len`` windows
    (incomplete tails dropped) and chunks are epoch-shuffled into groups
    of ``batch_size`` lanes. Iteration yields ``chain_len`` consecutive
    batches per group; lane b of consecutive batches follows one chunk.
    State resets are therefore GLOBAL and static-shaped: the trainer
    passes ``hc=None`` whenever ``step % chain_len == 0`` and threads the
    carried state otherwise — no per-lane reset masks, no dynamic
    shapes, one compiled executable per (cold, carried) variant.

    No batch ever straddles a sequence boundary, and no chain crosses
    one (chains are built inside each sequence's window range).
    """

    def __init__(self, seq_num_windows: Sequence[int], batch_size: int,
                 chain_len: int, stride: int, shuffle: bool = True,
                 seed: int = 0):
        if chain_len < 2:
            raise ValueError(f"chain_len={chain_len} must be >= 2 "
                             "(a 1-window chain never carries state)")
        self.batch_size = batch_size
        self.chain_len = chain_len
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        chunks: List[List[int]] = []
        first = 0
        for n in seq_num_windows:
            for off in range(min(stride, n)):
                chain = list(range(first + off, first + n, stride))
                for i in range(0, len(chain) - chain_len + 1, chain_len):
                    chunks.append(chain[i: i + chain_len])
            first += n
        if len(chunks) < batch_size:
            raise ValueError(
                f"only {len(chunks)} chain chunks of {chain_len} windows "
                f"(stride {stride}) exist — fewer than batch_size="
                f"{batch_size}; shorten chain_len or the batch"
            )
        self.chunks = chunks

    def __iter__(self):
        order = np.arange(len(self.chunks))
        if self.shuffle:
            self._rng.shuffle(order)
        n_groups = len(order) // self.batch_size
        for g in range(n_groups):
            grp = [self.chunks[j]
                   for j in order[g * self.batch_size:(g + 1) * self.batch_size]]
            for k in range(self.chain_len):
                yield [c[k] for c in grp]

    def __len__(self) -> int:
        return (len(self.chunks) // self.batch_size) * self.chain_len
