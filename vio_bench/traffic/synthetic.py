"""A frozen copy of the synthetic KITTI writer of the measured program
(``ode_vio_tpu_torch/data/synthetic.py``), kept with the benchmark so that
a change to the program cannot change the traffic.

The writer draws a smooth trajectory, its pseudo-IMU and PNG frames (a
shifted base texture plus noise) from ``np.random.default_rng(seed)`` and
writes them in KITTI's on-disk layout (poses/SS.txt,
sequences/SS/times.txt, sequences/SS/image_2/*.png, imus/SS.mat); the two
geometry helpers it needs are copied beside it. :func:`frames` draws the
same frames in memory, as float32 images centred on 0, for the served
windows.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def euler_to_matrix(theta) -> np.ndarray:
    """Rotation matrix ``Rz(rz) @ Ry(ry) @ Rx(rx)`` from Euler angles."""
    rx, ry, rz = float(theta[0]), float(theta[1]), float(theta[2])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return np.array(
        [
            [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
            [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
            [-sy, sx * cy, cx * cy],
        ]
    )


def save_trajectory(poses, path) -> None:
    """Write 4x4 poses as KITTI 12-float rows."""
    rows = np.asarray([np.asarray(P)[:3, :4].reshape(-1) for P in poses])
    np.savetxt(path, rows, fmt="%.9g")


def frames(n_frames: int, img_hw, rng: np.random.Generator) -> np.ndarray:
    """(n_frames, H, W, 3) float32 frames drawn as :func:`make_kitti_tree`
    draws its PNGs (the base texture shifted 2 pixels a frame, halved, plus
    uniform noise in [0, 20)), scaled to [0, 1] and centred on 0."""
    h, w = img_hw
    base = rng.integers(0, 255, (h, w, 3), np.uint8) // 2
    out = np.empty((n_frames, h, w, 3), np.float32)
    for k in range(n_frames):
        noise = rng.integers(0, 20, (h, w, 3), np.uint8)
        np.add(np.roll(base, shift=k * 2, axis=1), noise, out=out[k], dtype=np.float32)
    out *= np.float32(1 / 255)
    out -= np.float32(0.5)
    return out



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
        step[:3, :3] = euler_to_matrix([0.001 * rng.normal(),
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
    workers: int = 1,
) -> Path:
    """Write a complete miniature KITTI odometry tree under ``root``; the
    IMU is the band-limited ``'noise'`` mode (the only one kept here).
    ``workers`` threads compress and write the PNGs (``zlib`` releases the
    interpreter lock); the draws stay in one thread and in order, so the
    files do not depend on it."""
    from concurrent.futures import ThreadPoolExecutor

    import scipy.io as sio

    root = Path(root)
    rng = np.random.default_rng(seed)
    (root / "poses").mkdir(parents=True, exist_ok=True)
    (root / "imus").mkdir(exist_ok=True)
    pool = ThreadPoolExecutor(max_workers=workers)
    writes = []
    for s in seqs:
        seq_dir = root / "sequences" / s
        (seq_dir / "image_2").mkdir(parents=True, exist_ok=True)

        poses = make_trajectory(n_frames, rng, speed_scale=speed_scale)
        save_trajectory(poses, root / "poses" / f"{s}.txt")

        ts = np.arange(n_frames) * dt
        if jitter > 0:
            ts = ts + rng.uniform(-jitter, jitter, n_frames) * dt
            ts = np.sort(ts)
        np.savetxt(seq_dir / "times.txt", ts, fmt="%.6f")

        if imu_mode != "noise":
            raise ValueError("the frozen writer keeps the 'noise' IMU mode only")
        imu = make_imu(n_frames, rng)
        sio.savemat(root / "imus" / f"{s}.mat", {"imu_data_interp": imu})

        h, w = img_hw
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        for k in range(n_frames):
            # shift the base texture so consecutive frames correlate
            img = np.roll(base, shift=k * 2, axis=1)
            noise = rng.integers(0, 20, (h, w, 3), np.uint8)
            writes.append(pool.submit(write_png, seq_dir / "image_2" / f"{k:06d}.png",
                                      img // 2 + noise))
    for w in writes:
        w.result()
    pool.shutdown()
    return root
