"""Synthetic mini-KITTI fixture: a hermetic, analytically-known dataset in
the exact on-disk layout the loaders expect (poses/SS.txt,
sequences/SS/times.txt, sequences/SS/image_2/*.png, imus/SS.mat).

The port's copy of ``ode_vio_tpu/data/synthetic.py``: the same
``np.random.default_rng(seed)`` draws in the same order, so from one seed
both packages write the same poses, times, IMU samples and pixels. The
PNGs are written with the standard library (:func:`write_png`: ``zlib``
and ``struct``), so the writer needs no imaging package.

Lets every eval/serve path run in tests and on the card without the
20 GB KITTI download. The trajectory is a smooth arc with analytic
relative poses; IMU channels are smooth band-limited signals consistent
in length (10*(N-1)+1 rows, the reference's pre-interpolated 100 Hz
layout: its ``dataset/imus/07.mat`` holds (11001, 6)).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ode_vio_tpu_torch.utils import geometry as geo


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB, non-interlaced PNG:
    every row with filter type 0 (none), the rows in one zlib stream."""
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


def make_trajectory(
    n_frames: int, rng: np.random.Generator, speed_scale: float = 1.0
) -> np.ndarray:
    """Absolute 4x4 poses along a smooth arc with gentle yaw and speed
    variation (shape (N, 4, 4)). ``speed_scale`` stretches the per-frame
    travel (~0.1 m at 1.0) so short fixtures can still cover the official
    100 m metric segments."""
    poses = [np.eye(4)]
    yaw_rate = 0.02 * np.sin(np.linspace(0, 3.0, n_frames - 1))
    speed = 1.0 + 0.3 * np.sin(np.linspace(0, 5.0, n_frames - 1))
    for k in range(n_frames - 1):
        step = np.eye(4)
        step[:3, :3] = geo.euler_to_matrix([0.001 * rng.normal(),
                                            yaw_rate[k], 0.0])
        step[:3, 3] = [0.02 * rng.normal(), 0.01 * rng.normal(),
                       speed[k] * 0.1 * speed_scale]
        poses.append(poses[-1] @ step)
    return np.asarray(poses)


def make_imu(n_frames: int, rng: np.random.Generator) -> np.ndarray:
    """(10*(N-1)+1, 6) smooth pseudo-IMU: gravity on az plus band-limited
    noise per channel."""
    n = 10 * (n_frames - 1) + 1
    t = np.linspace(0, 1, n)[:, None]
    freqs = rng.uniform(1.0, 8.0, (1, 6))
    phase = rng.uniform(0, 2 * np.pi, (1, 6))
    sig = 0.5 * np.sin(2 * np.pi * freqs * t + phase) + 0.05 * rng.normal(size=(n, 6))
    sig[:, 2] += 9.81
    return sig


def make_imu_odometric(
    poses: np.ndarray,
    ts: np.ndarray,
    rng: np.random.Generator,
    noise: float = 0.01,
) -> np.ndarray:
    """(10*(N-1)+1, 6) odometry-CONSISTENT pseudo-IMU: each frame
    interval's 10 samples carry that interval's body-frame velocity on the
    accelerometer channels (plus gravity on az) and its body angular rate
    on the gyro channels, so an 11-sample window *determines* the relative
    pose it straddles.

    This is a learnability fixture, not a physical IMU simulation (a real
    accelerometer measures specific force, recoverable only by
    integration): it makes the synthetic mini-KITTI tree end-to-end
    LEARNABLE — training on it must drive t_rel/r_rel toward zero, which
    the band-limited-noise default cannot (there the only learnable signal
    is the mean pose step). Channel layout matches the loaders'
    [ax, ay, az, gx, gy, gz] convention (hflip sign table,
    data/transforms.py; reference src/data/utils.py:383-403).
    """
    poses = np.asarray(poses, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    n_frames = poses.shape[0]
    n = 10 * (n_frames - 1) + 1
    sig = np.zeros((n, 6))
    for k in range(n_frames - 1):
        dt = max(ts[k + 1] - ts[k], 1e-6)
        rel = geo.relative_pose6dof(poses[k], poses[k + 1])
        body_vel = rel[3:6] / dt        # body-frame translation rate (m/s)
        body_rate = rel[0:3] / dt       # body-frame Euler rate (rad/s)
        sig[k * 10 : k * 10 + 10, 0:3] = body_vel
        sig[k * 10 : k * 10 + 10, 3:6] = body_rate
    sig[-1] = sig[-2]                   # final sample extends the last interval
    sig[:, 2] += 9.81                   # gravity on az, as the noise mode
    if noise > 0:
        sig += noise * rng.standard_normal(sig.shape)
    return sig


def make_kitti_tree(
    root,
    seqs=("00", "01"),
    n_frames: int = 40,
    img_hw=(32, 64),
    dt: float = 0.1,
    jitter: float = 0.0,
    seed: int = 0,
    speed_scale: float = 1.0,
    imu_mode: str = "noise",
) -> Path:
    """Write a complete miniature KITTI odometry tree under ``root``.

    ``imu_mode``: ``'noise'`` (default, band-limited signals — hermetic
    shape/protocol fixture) or ``'odometric'`` (IMU derived from the
    trajectory via :func:`make_imu_odometric` — an end-to-end LEARNABLE
    fixture for convergence evidence)."""
    import scipy.io as sio

    root = Path(root)
    rng = np.random.default_rng(seed)
    (root / "poses").mkdir(parents=True, exist_ok=True)
    (root / "imus").mkdir(exist_ok=True)
    for s in seqs:
        seq_dir = root / "sequences" / s
        (seq_dir / "image_2").mkdir(parents=True, exist_ok=True)

        poses = make_trajectory(n_frames, rng, speed_scale=speed_scale)
        geo.save_trajectory(poses, root / "poses" / f"{s}.txt")

        ts = np.arange(n_frames) * dt
        if jitter > 0:
            ts = ts + rng.uniform(-jitter, jitter, n_frames) * dt
            ts = np.sort(ts)
        np.savetxt(seq_dir / "times.txt", ts, fmt="%.6f")

        imu = (
            make_imu_odometric(poses, ts, rng)
            if imu_mode == "odometric"
            else make_imu(n_frames, rng)
        )
        sio.savemat(root / "imus" / f"{s}.mat", {"imu_data_interp": imu})

        h, w = img_hw
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        for k in range(n_frames):
            # shift the base texture so consecutive frames correlate
            img = np.roll(base, shift=k * 2, axis=1)
            noise = rng.integers(0, 20, (h, w, 3), np.uint8)
            write_png(seq_dir / "image_2" / f"{k:06d}.png", img // 2 + noise)
    return root
