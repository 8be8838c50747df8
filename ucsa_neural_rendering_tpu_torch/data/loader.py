"""Minimal host-side data loader: shuffle + collate + one prefetch thread
(a copy of the JAX package's data/loader.py, which replaces torch's
DataLoader in the reference's DataModules, ref:
nr4seg/lightning/*_data_module.py). Datasets are plain objects with
__len__/__getitem__ returning numpy trees; collation stacks leaves; batches
stay numpy until the trainer copies them to the device
(JointTrainer._batch). The shuffle of epoch e is
np.random.default_rng(seed + e), as in the JAX package.

Split loading (`shard(rank, size)`, the pretrain loop under a mesh): the
order and the batches stay the global ones, every global batch is padded
to a multiple of `size` (ceil(batch_size / size)·size rows) by repeating
its own items (wraparound), and each rank reads only its contiguous block
of that padded batch. A dataset with per-item random streams keeps the
global draw order: where it has `plan(index)` (advance the streams over
one item, return what its read needs) and `load(index, plan)`, every rank
plans every item of the global batch in order and loads only its own,
a padding row reusing its source item's plan; other datasets are indexed.
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
        self._shard = None

    def shard(self, rank: int, size: int):
        """Split loading (module docstring): iteration then yields
        (this rank's block of the padded global batch, pad [k] bool: the
        block's padding rows, n_real: the global batch's real items).
        Returns self."""
        self._shard = (rank, size)
        return self

    @property
    def sharded(self) -> bool:
        """Whether `shard` split this loader's batches over the ranks."""
        return self._shard is not None

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

    def _load(self, b):
        """One batch of indices b read and collated (split loading: this
        rank's block, with its pad flags and the real count)."""
        if self._shard is None:
            return self.collate_fn([self.dataset[int(i)] for i in b])
        rank, size = self._shard
        n = len(b)
        k = -(-self.batch_size // size)
        ds = self.dataset
        split = hasattr(ds, "plan") and hasattr(ds, "load")
        plans = [ds.plan(int(i)) for i in b] if split else None
        src = [p if p < n else (p - n) % n
               for p in range(rank * k, (rank + 1) * k)]
        items = [ds.load(int(b[j]), plans[j]) if split else ds[int(b[j])]
                 for j in src]
        pad = np.arange(rank * k, (rank + 1) * k) >= n
        return self.collate_fn(items), pad, n

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        batches = self._index_batches()
        self._epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._load(b)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b in batches:
                    q.put(self._load(b))
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
