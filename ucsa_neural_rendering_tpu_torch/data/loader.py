"""Minimal host-side data loader: shuffle + collate + one prefetch thread
(a copy of the JAX package's data/loader.py, which replaces torch's
DataLoader in the reference's DataModules, ref:
nr4seg/lightning/*_data_module.py). Datasets are plain objects with
__len__/__getitem__ returning numpy trees; collation stacks leaves; batches
stay numpy until the trainer copies them to the device
(JointTrainer._batch). The shuffle of epoch e is
np.random.default_rng(seed + e), as in the JAX package.
"""

import queue
import threading

import numpy as np


def default_collate(items: list):
    """Stack a list of samples leaf-wise. dicts/tuples of ndarrays/scalars."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(xs)) for xs in zip(*items))
    if first is None:
        return None
    if isinstance(first, str):
        return list(items)
    arr = np.asarray(items[0])
    if arr.dtype == object:
        return list(items)
    return np.stack([np.asarray(it) for it in items], axis=0)


class DataLoader:

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, seed=0, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch. Shuffle order is a pure function of
        (seed, epoch), so a resumed run that pins the epoch reproduces the
        exact batch order of an uninterrupted one (torch
        DistributedSampler.set_epoch's role). Propagates to the dataset when
        it has per-epoch randomness of its own."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = []
        for s in range(0, n, self.batch_size):
            b = idx[s:s + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                break
            batches.append(b)
        return batches

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        batches = self._index_batches()
        self._epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in b])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in batches:
                    q.put(self.collate_fn([self.dataset[int(i)] for i in b]))
                q.put(stop)
            except BaseException as e:  # propagate into the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()
