"""Async batched input pipeline: background batch assembly over the
native C++ decode runtime.

The port's copy of ``ode_vio_tpu/data/loader.py``. It replaces the
reference's torch DataLoader worker processes (its
``scripts/train_model.py:143-150``) with an in-process
pipeline: window image batches decode+resize inside the C++ thread pool
(GIL released), IMU/pose/timestamp assembly happens on a Python prefetch
thread, and ``prefetch_depth`` batches stay in flight so host IO overlaps
device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ode_vio_tpu_torch.data import native_loader
from ode_vio_tpu_torch.data.kitti import KittiDataset


class PrefetchingLoader:
    """Iterate (imgs, imus, gts, ts) batches with background prefetch.

    ``transform`` applies per-window after decode (the dataset's own
    transform is bypassed so decode can happen natively at the target
    resolution in one pass).

    ``rows``, a slice, keeps those rows of each batch the sampler gives (a
    data-parallel rank's, ``parallel/mesh.py::batch_rows``): only their
    windows are decoded, and ``transform`` still makes every row's random
    draws in row order (on a 1x1 stand-in image for the rows not kept), so
    a kept row is augmented as the whole batch's loader augments it.
    """

    def __init__(
        self,
        dataset: KittiDataset,
        sampler,
        img_hw: tuple[int, int],
        transform=None,
        prefetch_depth: int = 2,
        decode_threads: int = 4,
        use_native: Optional[bool] = None,
        rows: Optional[slice] = None,
    ):
        self.ds = dataset
        self.sampler = sampler
        self.img_hw = tuple(img_hw)
        self.transform = transform
        self.prefetch_depth = max(1, prefetch_depth)
        self.decode_threads = decode_threads
        if use_native is None:
            use_native = native_loader.is_available()
        self.use_native = use_native
        self.rows = rows

    def _assemble(self, idx_batch) -> tuple:
        every = [self.ds.samples[i] for i in idx_batch]
        kept = range(len(every)) if self.rows is None else range(len(every))[self.rows]
        windows = [every[k] for k in kept]
        n_frames = len(windows[0].img_paths)
        all_paths = [p for w in windows for p in w.img_paths]
        flat = native_loader.decode_batch(
            all_paths, self.img_hw, threads=self.decode_threads
        )
        # the decode order IS the batch layout: centering happens in place
        # and the (B, S, H, W, 3) batch is a reshape, not a stack — a
        # 554 MB flagship batch previously paid three full copies here
        # (subtract, stack, astype), ~5x the decode cost itself
        flat -= 0.5
        imgs = flat.reshape(len(windows), n_frames, *self.img_hw, 3)
        imus = np.stack([np.asarray(w.imus, np.float32) for w in windows])
        gts = np.stack([np.asarray(w.gts, np.float32) for w in windows])
        ts = np.stack(
            [np.asarray(w.timestamps, np.float32) for w in windows])
        if self.transform is None:
            return imgs, imus, gts, ts
        out = []
        for k, w in enumerate(every):
            if k in kept:
                j = kept.index(k)
                out.append(self.transform(imgs[j], imus[j], gts[j], ts[j]))
            else:  # the row's draws only
                self.transform(np.zeros((n_frames, 1, 1, 3), np.float32),
                               np.asarray(w.imus, np.float32), np.asarray(w.gts, np.float32),
                               np.asarray(w.timestamps, np.float32))
        cols = list(zip(*out))
        return tuple(
            np.stack(c, 0).astype(np.float32, copy=False) for c in cols
        )

    def __iter__(self) -> Iterator[tuple]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def producer():
            try:
                for idx_batch in self.sampler:
                    if stop.is_set():
                        return
                    q.put(self._assemble(idx_batch))
            except Exception as e:  # surface errors on the consumer side
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self) -> int:
        return len(self.sampler)
