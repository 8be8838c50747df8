"""Continual-learning replay mixers over the ScanNet-25k dataset (a port of
the JAX package's data/cl_mixers.py, the reference's `ScanNetCL` /
`ScanNetCLJoint`, ref: nr4seg/dataset/scannet_cl.py:11-82,
scannet_cl_joint.py:8-47): each wraps a per-scene dataset and attaches
`ngp_25k_ratio` ScanNet-25k frames, drawn at random, to every item as
replay. The joint mixer's collate is its scene dataset's three-way
collate (the reference's own is dead code, scannet_cl_joint.py:49-67).

Under split loading (data/loader.py `shard`) the replay draws keep JAX's
order: they come from one stream keyed (seed, epoch), advanced item by
item, so every rank advances it over the whole global batch (`plan`, the
draws only) and reads only its own items (`load`). A per-index key would
depart from JAX's draws at one rank.
"""

import numpy as np


class _EpochMixin:
    """set_epoch for the mixers: forwarded to both wrapped datasets (the
    DataLoader reaches only its direct dataset, and the 25k dataset's
    draws are a function of (seed, epoch, index)), and the replay draw
    re-keyed from (seed, epoch), so that a resumed run draws the same
    replay frames."""

    def set_epoch(self, epoch: int):
        for ds in (self.scannet_25k, self.scannet_ngp):
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)
        self._rng = np.random.default_rng((self._seed, int(epoch)))

    def plan(self, index):
        """The draws of the item at `index`, nothing read: the scene
        dataset's plan (where it has one) and the replay frames, the next
        ngp_25k_ratio draws of the stream."""
        scene = self.scannet_ngp.plan(index) \
            if hasattr(self.scannet_ngp, "plan") else None
        return scene, [int(self._rng.integers(0, len(self.scannet_25k)))
                       for _ in range(self.ngp_25k_ratio)]

    def _scene_item(self, index, plan):
        if plan[0] is None:
            return self.scannet_ngp[index]
        return self.scannet_ngp.load(index, plan[0])

    def _replay_items(self, plan):
        return [self.scannet_25k[rid] for rid in plan[1]]

    def __getitem__(self, index):
        return self.load(index, self.plan(index))


class ScanNetCLJoint(_EpochMixin):
    """The joint loop's mixer: the scene item's dict gains replay_img
    [k, H, W, 3] and replay_label [k, H, W] stacks."""

    def __init__(self, scannet_25k, scannet_ngp, ngp_25k_ratio=1, seed=0):
        self.scannet_25k = scannet_25k
        self.scannet_ngp = scannet_ngp
        self.ngp_25k_ratio = ngp_25k_ratio
        self._seed = seed
        self._rng = np.random.default_rng((seed, 0))

    def __len__(self):
        return len(self.scannet_ngp)

    def load(self, index, plan):
        ret = self._scene_item(index, plan)
        replay = self._replay_items(plan)
        ret["replay_img"] = np.stack([it[0] for it in replay], 0)
        ret["replay_label"] = np.stack([it[1] for it in replay], 0)
        return ret

    @property
    def collate(self):
        return self.scannet_ngp.collate


class ScanNetCL(_EpochMixin):
    """The finetune loop's mixer: (scene item, replay items), flattened
    into one batch by `collate` (ref scannet_cl.py:50-79)."""

    def __init__(self, scannet_25k, scannet_ngp, ngp_25k_ratio=1, seed=0):
        self.scannet_25k = scannet_25k
        self.scannet_ngp = scannet_ngp
        self.ngp_25k_ratio = ngp_25k_ratio
        self._seed = seed
        self._rng = np.random.default_rng((seed, 0))

    def __len__(self):
        return len(self.scannet_ngp)

    def load(self, index, plan):
        return self._scene_item(index, plan), self._replay_items(plan)

    @staticmethod
    def collate(batch):
        """(images [N, H, W, 3], labels [N, H, W], originals) over every
        scene item followed by its replay items."""
        items = [it for ngp_item, replay in batch for it in [ngp_item,
                                                             *replay]]
        return tuple(np.stack([it[k] for it in items], 0) for k in range(3))
