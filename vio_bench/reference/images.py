"""The reference's own frame loading: PNG decode with ``zlib`` and numpy,
and the resize the eval transform states.

* :func:`decode_png`: 8-bit RGB, non-interlaced PNGs whose rows all use
  filter type 0, as the benchmark's frozen writer writes them (anything
  else raises).
* :func:`resize_matrix`: the antialiased bilinear (triangle filter)
  resampling of the reference eval's ``TF.resize`` on PIL images: output
  pixel ``i`` centred at ``(i + 0.5) * scale`` in input pixels; when
  shrinking, the triangle's support widens to ``scale`` input pixels;
  taps from ``int(centre - support + 0.5)`` to ``int(centre + support +
  0.5)``, clipped to the image; weights normalised to sum to 1.
* :func:`load_frames`: frames at the model's size, in [0, 1], separable
  resampling in float64, then float32.
"""

from __future__ import annotations

import struct
import zlib
from functools import lru_cache

import numpy as np
import torch


def decode_png(path) -> np.ndarray:
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read here")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


@lru_cache(maxsize=8)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 resampling weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    m = np.zeros((out_size, in_size))
    for i in range(out_size):
        centre = (i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), in_size)
        x = np.arange(lo, hi)
        w = np.clip(1.0 - np.abs((x + 0.5 - centre) / filterscale), 0.0, None)
        if w.sum() > 0:
            m[i, lo:hi] = w / w.sum()
    return m


def load_frames(paths, out_hw, device) -> torch.Tensor:
    """(N, H, W, 3) float32 frames in [0, 1] at ``out_hw``."""
    out = []
    for p in paths:
        img = torch.from_numpy(decode_png(p).astype(np.float64)).to(device)
        my = torch.from_numpy(resize_matrix(img.shape[0], out_hw[0])).to(device)
        mx = torch.from_numpy(resize_matrix(img.shape[1], out_hw[1])).to(device)
        out.append((torch.einsum("oh,hwc,pw->opc", my, img, mx) / 255.0).float())
    return torch.stack(out)

