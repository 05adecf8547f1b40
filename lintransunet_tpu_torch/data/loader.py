"""Threaded prefetching loader: host aug pipeline -> device-ready batches
(the port's own copy of ``lintransunet_tpu/data/loader.py``).

Replaces torch DataLoader(num_workers=12, pin_memory) (train3D.py:184-187).
Worker threads run the numpy/scipy augmentations (which release the GIL in
scipy/numpy kernels); a bounded queue keeps a couple of batches ready so the
card never waits on the host. A C++ fast path for the crop/window kernels
lives in lintransunet_tpu_torch/native (used automatically when built).
"""

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


class DataLoader:
    """Minimal map-style loader: shuffling, batching, thread prefetch.

    Yields tuples of stacked numpy arrays with a leading batch dim, matching
    the reference loader's (B, num_samples, ...) nesting, which the train
    loop flattens (utils_3D_embed_full.py:46-47).

    ``rank`` of ``world_size`` (a data-parallel run's training loader):
    every rank shuffles alike, pads the order by wrap-around to a multiple
    of ``world_size`` (as torch's ``DistributedSampler``) and takes every
    ``world_size``-th item from its rank on; so the ranks cover the dataset,
    disjoint but for the padding, and run the same number of equal batches.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2, rank: int = 0, world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is not in a world of {world_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rank = rank
        self.world_size = world_size
        self._epoch = 0

    def _items(self) -> int:
        """This rank's number of items."""
        return -(-len(self.dataset) // self.world_size)

    def __len__(self) -> int:
        n = self._items()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Sequence[np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.world_size > 1:  # np.resize repeats the order cyclically
            order = np.resize(order, self._items() * self.world_size)[self.rank::self.world_size]
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def __iter__(self):
        self._epoch += 1
        work: "queue.Queue" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.num_workers)
        batches = list(self._batches())
        for i, b in enumerate(batches):
            work.put((i, b))
        results = {}
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i, idxs = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.dataset[int(j)] for j in idxs]
                    fields = list(zip(*items))
                    batch = tuple(np.stack(f) for f in fields)
                except BaseException as exc:  # propagate, don't hang
                    done.put((i, exc))
                else:
                    done.put((i, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            next_i = 0
            pending = {}
            while next_i < len(batches):
                while next_i not in pending:
                    try:
                        i, batch = done.get(timeout=5.0)
                    except queue.Empty:
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError(
                                "DataLoader workers exited without producing "
                                f"batch {next_i}")
                        continue
                    if isinstance(batch, BaseException):
                        raise batch
                    pending[i] = batch
                yield pending.pop(next_i)
                next_i += 1
        finally:
            stop.set()
