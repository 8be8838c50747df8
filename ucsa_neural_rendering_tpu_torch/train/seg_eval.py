"""The ScanNet-25k generalisation test (a port of the JAX package's
train/seg_eval.py; ref: joint_train_data_module.py:55-66, and the
finetune's tests before and after fitting, scripts/train_finetune.py:
115-118): one split construction and one evaluation loop, parameterised
by an `infer(images) -> labels` callable so that it serves the joint
loop's JointTrainer and, later, the finetune loop's SegTrainer.

Frames go through the seg net in static batches of 8: the last partial
batch is padded with slots of all −1 labels and a cached zero image, which
are never decoded and never reach the confusion matrix. Decode of batch
k + 1 overlaps inference of batch k through the DataLoader's prefetch
thread.
"""

import os

import numpy as np
import torch

from ..data import DataLoader, ScanNet, load_split
from ..metrics import SemanticsMeter

EVAL_BATCH = 8


def build_test_25k(exp, env, output_size):
    """The ScanNet-25k test split as a test-mode ScanNet, or None when no
    split file is configured, none is on disk, or its test list is empty
    (the reference's split.npz is a large file kept out of its
    repository)."""
    split_file = exp["data_module"].get("data_preprocessing", {}).get(
        "split_file")
    if not split_file:
        return None
    split_path = os.path.join(env["scannet_frames_25k"], split_file)
    if not os.path.isfile(split_path):
        return None
    split = load_split(split_path)
    if len(split["test"]) == 0:
        # an empty list would otherwise fail in the meter after training,
        # before the checkpoints are written
        return None
    return ScanNet(root=env["scannet_frames_25k"], img_list=split["test"],
                   mode="test", output_size=output_size)


class _PaddedView:
    """(img, label) pairs of `dataset`, padded to `total` items; a pad slot
    holds a zero image and all −1 labels."""

    def __init__(self, dataset, total):
        self._ds = dataset
        self._total = total
        self._pad = None

    def __len__(self):
        return self._total

    def __getitem__(self, i):
        if i >= len(self._ds):
            if self._pad is None:
                img, label = self[0]
                self._pad = (np.zeros_like(img), np.full_like(label, -1))
            return self._pad
        item = self._ds[i]
        return np.asarray(item[0]), np.asarray(item[1])


def eval_25k(infer, dataset, num_classes, batch_size=EVAL_BATCH):
    """`infer(images [B, H, W, 3] numpy) -> labels [B, H, W]` (a tensor on
    the model's device) over the dataset in batches of batch_size.
    Returns (mIoU, total accuracy, mean accuracy)."""
    meter = SemanticsMeter(num_classes)
    total = -(-len(dataset) // batch_size) * batch_size
    loader = DataLoader(_PaddedView(dataset, total), batch_size=batch_size)
    for images, labels in loader:
        preds = infer(images)
        meter.update(preds, torch.as_tensor(labels, device=preds.device))
    return meter.measure()
