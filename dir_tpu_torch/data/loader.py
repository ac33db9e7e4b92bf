"""Threaded prefetching batch loader (counterpart of
``dir_tpu/data/loader.py``).

Per-sample decode and augmentation run in worker threads (cv2 and numpy
release the GIL for the heavy parts) while the device consumes the
previous batch. The order is a pure function of ``seed + epoch``, so the
same seed gives the same batches as the JAX package's loader (a
``torch.utils.data`` sampler would give another order). With
``pin_memory`` the batches are collated straight into pinned host
tensors, so that the step's ``non_blocking`` copy to the card overlaps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def collate(samples, pin_memory: bool = False) -> Dict[str, object]:
    """Stack the samples' arrays key by key: numpy arrays, or with
    ``pin_memory`` torch tensors in pinned host memory (stacked in place,
    no second copy)."""
    out = {}
    for key in samples[0]:
        arrs = [np.asarray(s[key]) for s in samples]
        if pin_memory:
            dtype = torch.from_numpy(arrs[0][None][:0]).dtype
            t = torch.empty((len(arrs),) + arrs[0].shape, dtype=dtype,
                            pin_memory=True)
            np.stack(arrs, out=t.numpy())
            out[key] = t
        else:
            out[key] = np.stack(arrs)
    return out


class BatchLoader:
    """Iterable over shuffled, collated batches with background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_threads: int = 4,
                 prefetch: int = 2, seed: int = 0,
                 pad_last: bool = False, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch counter (the shuffle order's seed and the dataset's
        augmentation stream), so that a resumed run replays the same
        schedule."""
        self._epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(idx)
        batches = []
        for s in range(0, n, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_last:
                    # a fixed batch shape: repeat the last sample and report
                    # the real count, so that metrics can mask the padding
                    pad = np.full(self.batch_size - len(chunk), chunk[-1])
                    batches.append((np.concatenate([chunk, pad]), len(chunk)))
                    continue
            batches.append((chunk, len(chunk)))
        return batches

    def _collate(self, samples, valid: int) -> dict:
        batch = collate(samples, self.pin_memory)
        batch["_valid"] = np.asarray(valid, np.int32)
        return batch

    def peek_batch(self) -> dict:
        """The first batch, built synchronously: no prefetch thread to
        leak, no epoch advance (for one-off uses such as int8 static-scale
        calibration)."""
        chunk, valid = self._index_batches()[0]
        return self._collate([self.dataset[i] for i in chunk], valid)

    def __iter__(self) -> Iterator:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator:
        """Iterate from batch index ``start`` in the order ``__iter__``
        would use this epoch; skipped batches are never decoded (a resumed
        eval fast-forwards at no decode cost)."""
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self._epoch
        batches = self._index_batches()[start:]
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_interruptible(item) -> bool:
            # a put that checks ``stop``: a plain blocking put would block
            # the producer forever once the consumer abandons the iterator
            # with the queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for chunk, valid in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                chunk))
                        if not put_interruptible(
                                self._collate(samples, valid)):
                            return
            except Exception as e:  # raised again in the consumer
                put_interruptible(e)
                return
            put_interruptible(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
