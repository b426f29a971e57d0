"""Host data loading: shuffled, prefetched batches of padded slots.

The port's copy of ``Dataloader`` (``pointcept_keypointdetection_tpu/
datasets/dataloader.py:27-135``) for one process: a permutation per epoch
from ``seed + epoch``, collation into padded slots (``collate.py``, whose
subsample draws from the global ``np.random`` as the JAX copy's does), a
background thread that prefetches batches, and ``num_workers`` threads that
prepare samples in parallel.  Not ported: sharding over processes and
Mix3D (``mix_prob``).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .collate import collate


class Dataloader:
    def __init__(self, dataset, batch_size: int, slot_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.slot_size = slot_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _samples(self, order):
        """Prepared samples in order, ``num_workers``-parallel."""
        if self.num_workers <= 0:
            for idx in order:
                yield self.dataset[int(idx)]
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futs: deque = deque()
            for idx in order:
                futs.append(pool.submit(self.dataset.__getitem__, int(idx)))
                if len(futs) >= 2 * self.num_workers:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

    def _batches(self):
        batch = []
        for sample in self._samples(self._indices()):
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield collate(batch, self.slot_size, np.random)
                batch = []
        if batch and not self.drop_last:
            yield collate(batch, self.slot_size, np.random)

    def _produce(self, out_q: queue.Queue, stop: threading.Event):
        try:
            for item in self._batches():
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            out_q.put(e)
        finally:
            out_q.put(None)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while worker.is_alive():  # drain, so that a blocked put returns
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            worker.join()
