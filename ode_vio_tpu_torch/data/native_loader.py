"""ctypes bindings for the port's C++ decode runtime (``csrc/vioio.cpp``).

The port's copy of ``ode_vio_tpu/data/native_loader.py``. At first use
it builds the shared library with ``g++ -O3 -shared -fPIC -pthread ...
-lz`` into ``ode_vio_tpu_torch/_build/`` (listed in ``.gitignore``); the
library's file name carries the hash of its source, as the kernels'
libraries do, so an edited source is rebuilt. It exposes:

  * :func:`decode_batch` — threaded PNG decode + bilinear resize into one
    float32 NHWC array,
  * :class:`Prefetcher` — ticketed async prefetch so the next window's
    decode overlaps device compute (the torch DataLoader-worker
    capability, without process forks).

When the build fails it decodes with PIL, as the JAX package does
(``is_available()`` reports which path is active, ``build_error()`` why
the build failed). Both are host decode: no device work happens here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_SRC = _PACKAGE_DIR / "csrc" / "vioio.cpp"
_BUILD_DIR = _PACKAGE_DIR / "_build"

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libvioio-{digest}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    out = library_path()
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            "g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-pthread",
            str(_SRC), "-o", str(tmp), "-lz",
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:  # no compiler at all
            _build_error = str(e)
            return None
        if proc.returncode != 0:
            _build_error = proc.stderr[-2000:]
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.vio_decode_batch.restype = ctypes.c_int
    lib.vio_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.vio_prefetcher_create.restype = ctypes.c_void_p
    lib.vio_prefetcher_create.argtypes = [ctypes.c_int]
    lib.vio_prefetcher_submit.restype = None
    lib.vio_prefetcher_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.vio_prefetcher_get.restype = ctypes.c_int
    lib.vio_prefetcher_get.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.vio_prefetcher_destroy.restype = None
    lib.vio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is None and _build_error is None:
            _lib = _build()
    return _lib


def is_available() -> bool:
    return _get_lib() is not None


def build_error() -> Optional[str]:
    return _build_error


def _path_array(paths: Sequence) -> "ctypes.Array":
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def decode_batch(paths: Sequence, out_hw: tuple[int, int],
                 threads: int = 4) -> np.ndarray:
    """Decode + resize PNGs into (N, H, W, 3) float32 in [0, 1]."""
    lib = _get_lib()
    h, w = out_hw
    if lib is None:  # PIL fallback
        from ode_vio_tpu_torch.data.kitti import load_images

        return load_images(paths, size_hw=out_hw)
    out = np.empty((len(paths), h, w, 3), np.float32)
    rc = lib.vio_decode_batch(
        _path_array(paths), len(paths), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads,
    )
    if rc != 0:
        raise IOError(f"native decode failed for batch of {len(paths)}")
    return out


class Prefetcher:
    """Async ticketed image prefetch: ``submit`` the next batch's paths,
    ``get`` blocks only if decode hasn't finished yet."""

    def __init__(self, out_hw: tuple[int, int], threads: int = 4):
        self._lib = _get_lib()
        self.out_hw = tuple(out_hw)
        self._pil_results = {}
        self._counts = {}
        if self._lib is not None:
            self._handle = self._lib.vio_prefetcher_create(threads)
        else:
            self._handle = None

    def submit(self, ticket: int, paths: Sequence) -> None:
        self._counts[ticket] = len(paths)
        if self._handle is None:
            self._pil_results[ticket] = decode_batch(paths, self.out_hw)
            return
        h, w = self.out_hw
        self._lib.vio_prefetcher_submit(
            self._handle, _path_array(paths), len(paths), h, w, ticket
        )

    def get(self, ticket: int) -> np.ndarray:
        n = self._counts.pop(ticket)
        if self._handle is None:
            return self._pil_results.pop(ticket)
        h, w = self.out_hw
        out = np.empty((n, h, w, 3), np.float32)
        rc = self._lib.vio_prefetcher_get(
            self._handle, ticket,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
        )
        if rc != 0:
            raise IOError(f"native prefetch failed for ticket {ticket}")
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vio_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
