"""Train/val/test split generation for scannet_frames_25k (a copy of the
JAX package's data/splits.py; ref: nr4seg/dataset/create_split.py:25-40):
glob the frame images, shuffle, carve off `val_ratio` for val (test = val,
as in the reference), save as .npz with train/val/test plus a `train_cl`
array.
"""

import os
import random
from glob import glob

import numpy as np


def create_split(root: str, image_regex: str = "/*/color/*.jpg",
                 val_ratio: float = 0.2, seed: int | None = None):
    """Returns dict with train/val/test/train_cl lists of paths."""
    train_all = glob(root + image_regex)
    if seed is not None:
        random.Random(seed).shuffle(train_all)
    else:
        random.shuffle(train_all)
    n_val = int(len(train_all) * val_ratio)
    val = train_all[:n_val]
    train = train_all[n_val:]
    test = val  # test = val split, as shipped (ref create_split.py:29-31)
    train, val, test = map(sorted, (train, val, test))
    return {"train": np.array(train), "val": np.array(val),
            "test": np.array(test), "train_cl": np.array(train)}


def save_split(split: dict, out_file: str):
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    np.savez(out_file, **split)


def load_split(path: str) -> dict:
    return dict(np.load(path, allow_pickle=True))
