"""ScanNet-25k frames dataset, the segmentation pretraining set and the
continual-learning replay source (a port of the JAX package's
data/scannet.py, the reference's `ScanNet`, ref:
nr4seg/dataset/scannet.py:19-137): a JPEG frame and its label PNG (the
label path is the image path with color → label and jpg → png), decoded
by LabelLoaderAuto, rescaled to the canonical size
(augmentation.rescale_to_canonical), augmented on the host
(augmentation.host_augment; `augment_params` replaces its draw, e.g. to
replay the JAX package's), labels shifted by −1 (0 → −1, ignored), and a
frame with fewer than 10 labelled pixels redirected to another drawn
from the same per-(seed, epoch, index) stream as the JAX package's.
Items are (img [H, W, 3] f32 in [0, 1], label [H, W] int32, img_ori), and
with aux labels on (img, label, aux_label, aux_valid, img_ori).

Aux labels (ref scannet.py:64-137,155-234): an optional second label
stream a frame (pseudo-labels of an earlier stage), which takes the main
label's crop and flip. `enable_aux_labels(paths)` turns it on;
probability-packed RGBA aux files are converted once to FAST `<tag>.png`
siblings (uint8 argmax at the configured confidence, written by
image_io.write_png). `set_aux_labels_fake(True)` fills the slot with the
main label and valid=False.
"""

import os

import numpy as np

from .augmentation import host_augment, rescale_to_canonical
from .image_io import read_rgb, write_png
from .label_loader import LabelLoaderAuto

MIN_LABELLED = 10  # fewer labelled pixels than this: redraw the frame
MAX_REDRAWS = 16


def _fast_tag(confidence):
    """Suffix of a converted aux label. The conversion bakes the loader's
    confidence floor into the stored argmax, so the tag names it: another
    `confidence_aux` converts afresh instead of reusing a stale file."""
    return "_" if confidence == 0 else f"_c{confidence:g}_"


def preprocess_aux_labels(paths, loader):
    """One-time RGBA → FAST conversion (ref scannet.py:155-234): decode each
    RGBA aux label once and write its argmax (at the loader's confidence
    floor) as a uint8 `<tag>.png` that decodes as FAST on every later
    epoch. Returns the swapped path list. Converted paths, other formats
    and missing files pass through (a missing file raises when read)."""
    out = []
    tag = _fast_tag(loader.confidence)
    for p in paths:
        if p.endswith(tag + ".png") or not os.path.isfile(p):
            out.append(p)
            continue
        fast_p = p[:-len(".png")] + tag + ".png"
        if not os.path.isfile(fast_p):
            label, method = loader.get(p)
            if method != "RGBA":  # already cheap to load; keep as-is
                out.append(p)
                continue
            write_png(fast_p, label.astype(np.uint8))
        out.append(fast_p)
    return out


class ScanNet:

    def __init__(self, root, img_list, mode="train", output_size=(240, 320),
                 data_augmentation=True, seed=0, confidence_aux=0,
                 augment_params=None):
        self.root = root
        self.image_pths = [str(p) for p in img_list]
        self.label_pths = [p.replace("color", "label").replace("jpg", "png")
                           for p in self.image_pths]
        self._mode = mode
        self._output_size = tuple(output_size)
        self._data_augmentation = data_augmentation
        self._seed = seed
        self._augment_params = augment_params
        self._label_loader = LabelLoaderAuto(root_scannet=root,
                                             confidence=confidence_aux)
        self._epoch = 0
        self.aux_labels = False
        self.aux_labels_fake = False
        self.aux_label_pths = None

    def enable_aux_labels(self, aux_label_pths):
        """Attach a per-frame aux label stream; RGBA files are converted
        once to FAST siblings (ref `_preprocessing_hack`)."""
        if len(aux_label_pths) != len(self.image_pths):
            raise ValueError(f"{len(aux_label_pths)} aux labels for "
                             f"{len(self.image_pths)} frames")
        self.aux_label_pths = preprocess_aux_labels(
            [str(p) for p in aux_label_pths], self._label_loader)
        self.aux_labels = True
        self.aux_labels_fake = False

    def set_aux_labels_fake(self, flag=True):
        """(ref scannet.py:71-73) the aux slot filled with the main label
        and valid=False, which keeps a stage without pseudo-labels' collate
        shapes."""
        self.aux_labels_fake = flag
        self.aux_labels = flag

    def __len__(self):
        return len(self.image_pths)

    def set_epoch(self, epoch: int):
        """Pin the epoch: every draw of __getitem__ is a function of (seed,
        epoch, index), so a resumed run replays an uninterrupted one's."""
        self._epoch = int(epoch)

    def _read_aux(self, index):
        """The aux label plane, the FAST-converted file preferred, else its
        unconverted source (ref scannet.py:83-97)."""
        p = self.aux_label_pths[index]
        tag = _fast_tag(self._label_loader.confidence)
        if not os.path.isfile(p) and p.endswith(tag + ".png"):
            p = p[:-len(tag + ".png")] + ".png"
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"aux label missing for frame {index}: neither "
                f"{self.aux_label_pths[index]} nor its unconverted source "
                f"exists")
        aux, _ = self._label_loader.get(p)
        return aux.astype(np.float32)

    def _load(self, index, aug_seed):
        label, _ = self._label_loader.get(self.label_pths[index])
        labels = [label.astype(np.float32)]  # 0..40, 0 = unlabelled
        if self.aux_labels and not self.aux_labels_fake:
            labels.append(self._read_aux(index))
        img = read_rgb(self.image_pths[index]).astype(np.float32) / 255.0
        img, labels = rescale_to_canonical(img, labels, self._output_size)
        train = "train" in self._mode and self._data_augmentation
        # one draw for every label plane: aux takes the main label's crop
        # and flip
        img, labels = host_augment(aug_seed, img, labels, self._output_size,
                                   only_crop=not train,
                                   params_fn=self._augment_params)
        return img, [lab.astype(np.int64) - 1 for lab in labels]

    def __getitem__(self, index):
        rng = np.random.default_rng((self._seed, self._epoch, index))
        img, labels = self._load(index, int(rng.integers(0, 2 ** 31)))
        # resample-on-reject (ref scannet.py:116-121) on the main label,
        # bounded, from the same stream, so that a chain cannot cycle
        for _ in range(MAX_REDRAWS):
            if (labels[0] != -1).sum() >= MIN_LABELLED:
                break
            j = int(rng.integers(0, len(self)))
            img, labels = self._load(j, int(rng.integers(0, 2 ** 31)))
        img = img.astype(np.float32)
        ret = (img, labels[0].astype(np.int32))
        if self.aux_labels:
            if self.aux_labels_fake:
                ret += (labels[0].astype(np.int32), False)
            else:
                ret += (labels[1].astype(np.int32), True)
        return ret + (img,)

    def __str__(self):
        return (f"ScanNet25k[{len(self)} samples, mode={self._mode}, "
                f"aug={self._data_augmentation}]")
