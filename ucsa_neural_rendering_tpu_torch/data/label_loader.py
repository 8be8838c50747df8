"""ScanNet label decoding: three on-disk encodings → 0..40 class maps (a
port of the JAX package's data/label_loader.py, the reference's
LabelLoaderAuto, ref: nr4seg/dataset/label_loader.py:10-79):
  * RGBA  — probability-packed 16-bit RGBA: in each of the R, G and B
            samples, bits 10+ hold a class and the low 10 bits its
            probability × 1023; the three channels scatter into a 40-class
            volume in channel order (a later channel overwrites an earlier
            one of the same class), the volume argmaxes (ties to the lowest
            class), +1, and a best probability under the confidence floor
            gives 0. Classes ≥ 40 get probability 0.
  * FAST  — a plain uint8 class map.
  * MAPPED— uint16 raw ScanNet ids, looked up through
            scannetv2-labels.combined.tsv's id → nyu40id columns.

Files are read by data/image_io.read_png, which keeps 16-bit samples and
gives RGB(A) in the file's order (the JAX package swaps cv2's BGR back);
a paletted or otherwise unsupported PNG raises, naming the file. The tsv
is read with the standard csv module.
"""

import csv
import os

import numpy as np

from .image_io import read_png

MAX_CLASSES = 40


def read_label_png(path: str) -> np.ndarray:
    """A label PNG as stored (uint8 or uint16, [H, W] or [H, W, C]); an
    unsupported file raises ValueError naming it."""
    try:
        return read_png(path)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


def load_label_mapping(root: str) -> np.ndarray:
    """int64 lookup table raw ScanNet id → nyu40id from
    <root>/scannetv2-labels.combined.tsv (ids absent from the file map to
    0)."""
    tsv = os.path.join(root, "scannetv2-labels.combined.tsv")
    src, tgt = [], []
    with open(tsv, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                src.append(int(row["id"]))
                tgt.append(int(row["nyu40id"]))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"{tsv}: row {row!r} has no integer id and "
                                 f"nyu40id") from e
    if not src:
        raise ValueError(f"{tsv}: no rows")
    mapping = np.zeros(max(src) + 1, dtype=np.int64)
    mapping[np.asarray(src)] = np.asarray(tgt)
    return mapping


def _unpack(img: np.ndarray):
    """[H, W, ≥3] packed samples → (classes int64 [H, W, 3], probabilities
    f32 [H, W, 3])."""
    chans = img[:, :, :3].astype(np.uint16)
    probs = (chans & np.uint16(0x3FF)).astype(np.float32) / 1023.0
    return (chans >> 10).astype(np.int64), probs


class LabelLoaderAuto:

    def __init__(self, root_scannet: str | None = None, confidence: float = 0):
        if root_scannet is None:
            raise ValueError("LabelLoaderAuto needs root_scannet (the "
                             "folder of scannetv2-labels.combined.tsv)")
        self.confidence = confidence
        self.max_classes = MAX_CLASSES
        self._mapping = load_label_mapping(root_scannet)

    def get(self, path: str):
        """(label int32 [H, W] in 0..40, the format: "RGBA", "FAST" or
        "MAPPED")."""
        img = read_label_png(path)
        if img.ndim == 3:
            if img.shape[2] != 4:
                raise ValueError(f"unknown label format {img.shape} at {path}")
            return self._decode_rgba(img), "RGBA"
        if img.dtype == np.uint8:
            return img.astype(np.int32), "FAST"
        ids = img.astype(np.int64)
        if ids.max() >= len(self._mapping):
            raise ValueError(f"{path}: raw id {ids.max()} is beyond the "
                             f"label tsv's largest id "
                             f"{len(self._mapping) - 1}")
        return self._mapping[ids].astype(np.int32), "MAPPED"

    def _decode_rgba(self, img: np.ndarray) -> np.ndarray:
        classes, probs = _unpack(img)
        oob = classes >= self.max_classes
        classes = np.minimum(classes, self.max_classes - 1)
        probs = np.where(oob, np.float32(0.0), probs)
        vol = np.zeros((*classes.shape[:2], self.max_classes), np.float32)
        np.put_along_axis(vol, classes, probs, axis=2)
        label = (vol.argmax(axis=2) + 1).astype(np.int32)
        label[vol.max(axis=2) < self.confidence] = 0
        return label

    def get_probs(self, path: str) -> np.ndarray:
        """The f32 [H, W, 40] probability volume of an RGBA-packed label;
        a class ≥ 40 raises, naming the file."""
        img = read_label_png(path)
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f"{path}: get_probs needs an RGBA-packed label, "
                             f"not {img.dtype} {img.shape}")
        classes, probs = _unpack(img)
        if classes.max() >= self.max_classes:
            raise ValueError(f"{path}: class {classes.max()} is beyond the "
                             f"{self.max_classes} classes")
        out = np.zeros((*classes.shape[:2], self.max_classes), np.float32)
        np.put_along_axis(out, classes, probs, axis=2)
        return out
