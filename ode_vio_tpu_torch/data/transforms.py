"""Host-side data augmentation pipeline (numpy, NHWC).

The port's copy of ``ode_vio_tpu/data/transforms.py``, with the same
numpy random draws. Capability parity with the reference's
``src/data/utils.py:301-451`` and the pipeline assembly in its
``src/data/transforms.py:11-29``: centering, resize,
horizontal flip with the matching IMU-axis and pose-component sign flips,
photometric (gamma/brightness/per-channel color) augmentation, and image /
IMU normalisation with the KITTI statistics.

All transforms take and return ``(imgs (S,H,W,3) float, imus, gts, ts)``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

# KITTI 100 Hz IMU channel statistics (ax, ay, az, gx, gy, gz) — dataset
# facts used by the reference's NormalizeIMU (src/data/transforms.py:24-26).
KITTI_IMU_MEAN = np.array(
    [-0.0648819, 0.0790280, 9.7907759, 0.0001441, 0.0005592, -0.0065768],
    np.float32,
)
KITTI_IMU_STD = np.array(
    [1.0056580, 1.2166066, 0.4031517, 0.0241202, 0.0272774, 0.1716295],
    np.float32,
)
# Per-channel image means (reference normalizes /255 then subtracts these).
KITTI_IMG_MEAN = np.array([0.45, 0.432, 0.411], np.float32)


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, imgs, imus, gts, ts):
        for t in self.transforms:
            imgs, imus, gts, ts = t(imgs, imus, gts, ts)
        return imgs, imus, gts, ts


class Center:
    """[0,1] images -> zero-centered (reference ToTensor subtracts 0.5)."""

    def __call__(self, imgs, imus, gts, ts):
        return imgs - 0.5, imus, gts, ts


class Resize:
    """Bilinear resize to (h, w) (reference TF.resize to (256, 512))."""

    def __init__(self, size_hw=(256, 512)):
        self.size_hw = tuple(size_hw)

    def __call__(self, imgs, imus, gts, ts):
        from PIL import Image

        h, w = self.size_hw
        if imgs.shape[1] == h and imgs.shape[2] == w:
            return imgs, imus, gts, ts
        out = []
        for im in imgs:
            shifted = np.clip((im + 0.5) * 255.0, 0, 255).astype(np.uint8)
            resized = Image.fromarray(shifted).resize((w, h), Image.BILINEAR)
            out.append(np.asarray(resized, np.float32) / 255.0 - 0.5)
        return np.stack(out, 0), imus, gts, ts


class RandomHorizontalFlip:
    """Flip images left-right with prob p; negate the IMU lateral axes
    (ay, gx, gz = columns 1, 3, 5) and the pose components that change
    handedness (ry, rz, tx = columns 1, 2, 3) — utils.py:383-403."""

    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, imgs, imus, gts, ts):
        if self.rng.random() < self.p:
            imgs = imgs[:, :, ::-1, :].copy()
            imus = imus.copy()
            gts = gts.copy()
            imus[:, [1, 3, 5]] *= -1.0
            gts[:, [1, 2, 3]] *= -1.0
        return imgs, imus, gts, ts


class RandomColorAug:
    """Random gamma / brightness / per-channel color shift on centered
    images, saturated to [0,1] (utils.py:406-451)."""

    def __init__(self, params=(0.8, 1.2, 0.5, 2.0, 0.8, 1.2), p: float = 0.5,
                 rng=None):
        (self.g_lo, self.g_hi, self.b_lo, self.b_hi,
         self.c_lo, self.c_hi) = params
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, imgs, imus, gts, ts):
        if self.rng.random() < self.p:
            x = imgs + 0.5
            x = x ** self.rng.uniform(self.g_lo, self.g_hi)
            x = x * self.rng.uniform(self.b_lo, self.b_hi)
            x = x * self.rng.uniform(self.c_lo, self.c_hi, 3).astype(np.float32)
            imgs = np.clip(x, 0.0, 1.0) - 0.5
        return imgs, imus, gts, ts


class Normalize:
    """Subtract KITTI per-channel image means and standardise IMU channels
    (src/data/transforms.py:19-26)."""

    def __init__(self, img_mean=KITTI_IMG_MEAN, imu_mean=KITTI_IMU_MEAN,
                 imu_std=KITTI_IMU_STD):
        self.img_mean = np.asarray(img_mean, np.float32)
        self.imu_mean = np.asarray(imu_mean, np.float32)
        self.imu_std = np.asarray(imu_std, np.float32)

    def __call__(self, imgs, imus, gts, ts):
        # reference order: images already centered at -0.5..0.5; it divides
        # by 255 then subtracts the channel means of the 0..1 image — the
        # composed effect here: shift centered image by (0.5 - mean).
        imgs = imgs + (0.5 - self.img_mean)
        imus = (imus - self.imu_mean) / self.imu_std
        return imgs, imus, gts, ts


def get_transforms(img_hw=(256, 512), hflip=False, color=False,
                   normalize=False, rng=None, base: bool = True) -> Compose:
    """Assemble the train pipeline from flags
    (src/data/transforms.py:11-29). ``base=False`` drops the
    Center+Resize head for pipelines where the native loader already
    decodes at target resolution in [0,1]-centered form."""
    ts: List[Callable] = [Center(), Resize(img_hw)] if base else []
    if hflip:
        ts.append(RandomHorizontalFlip(rng=rng))
    if color:
        ts.append(RandomColorAug(rng=rng))
    if normalize:
        ts.append(Normalize())
    return Compose(ts)
