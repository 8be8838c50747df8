"""Checkpoint save / load on torch.save and torch.load (counterpart of the
JAX package's train/checkpoints.py, which writes orbax trees).

Replaces the reference's Lightning ModelCheckpoint + manual torch.save
chaining (ref: scripts/pretrain.py:70-78, scripts/train_joint.py:183-186,
scripts/cl_deeplab.py:76-86): each continual-learning stage saves the
segmentation net as `deeplab_ckpt/` and the next stage loads it; the
first stage may instead load a torchvision / Lightning checkpoint file
(models/convert.py: aux head and wrapper prefixes dropped). A checkpoint
here is a directory holding one `tree.pt`: a tree of dicts, lists,
tensors and numbers (state dicts, optimizer state dicts, counters), read
back with weights_only=True.
"""

import os
import shutil

import torch

from ..models.convert import read_deeplab_checkpoint

TREE_FILE = "tree.pt"


def save_tree(path: str, tree):
    """Save `tree` at `path` (a directory).

    Write-then-swap: the tree lands in a sibling `.tmp` dir first; the old
    checkpoint is then renamed aside (one syscall), the new one renamed in,
    and only then is the old one deleted — so at every instant either the
    old or the new checkpoint exists at `path` up to a rename window. The
    per-epoch `last_ckpt` is the resume anchor: losing it silently restarts
    training from epoch 0."""
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, TREE_FILE))
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def load_tree(path: str, map_location="cpu"):
    """The tree saved at `path`, its tensors on `map_location` (the
    trainer's device)."""
    return torch.load(os.path.join(os.path.abspath(path), TREE_FILE),
                      map_location=map_location, weights_only=True)


def save_deeplab(path: str, state: dict):
    """Stage-chaining seg checkpoint (the reference's `deeplab.ckpt`): a
    DeepLabV3 state dict (weights and BN running stats)."""
    save_tree(path, {"state_dict": state})


def load_deeplab(path: str, map_location="cpu") -> dict:
    """A DeepLabV3 state dict from this package's directory, or from a
    reference torchvision / Lightning .ckpt / .pth file (unpickled: load
    only files you trust)."""
    if os.path.isdir(path):
        return load_tree(path, map_location)["state_dict"]
    return {k: v.to(map_location)
            for k, v in read_deeplab_checkpoint(path).items()}
