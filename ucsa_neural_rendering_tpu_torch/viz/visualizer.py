"""Image / segmentation visualization written to disk (and optionally a
logger), mirroring the reference's Visualizer surface (ref:
nr4seg/visualizer/visualizer.py:86-227; counterpart of the JAX package's
viz/visualizer.py): plot_image, plot_segmentation (ScanNet palette), and
plot_detectron (palette overlay + class-boundary outlines), in numpy, the
PNGs written through data/image_io.py.
"""

import os

import numpy as np

from ..data.image_io import write_png
from .colormaps import NYU40_COLOUR_CODE, SCANNET_CLASS_NAMES


def _to_uint8_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (3, 4) and img.shape[0] < img.shape[-1]:
        img = np.transpose(img, (1, 2, 0))  # CHW → HWC
    if img.ndim != 3 or img.shape[2] < 3:
        # the reference raises on non-image shapes too (ref visualizer.py
        # plot_image "Wrong data format") — slicing an HW array to
        # (H, 3) silently would produce garbage
        raise ValueError(f"plot_image expects HWC/CHW rgb(a), got shape "
                         f"{img.shape}")
    if img.dtype != np.uint8:
        img = img.astype(np.float32)
        if img.max() <= 1.0:
            # reference auto-detects range 0-1 vs 0-255
            # (ref visualizer.py plot_image)
            img = img * 255.0
        img = np.clip(img, 0.0, 255.0).astype(np.uint8)
    return img[..., :3]


def colorize_label(label, palette: np.ndarray = NYU40_COLOUR_CODE) -> np.ndarray:
    """Label map (values index the palette; clip out-of-range) → HWC uint8."""
    label = np.asarray(label).astype(np.int64)
    label = np.clip(label, 0, len(palette) - 1)
    return palette[label]


def _class_boundaries(label: np.ndarray) -> np.ndarray:
    """Boolean mask of pixels adjacent to a different class."""
    b = np.zeros(label.shape, dtype=bool)
    b[:-1, :] |= label[:-1, :] != label[1:, :]
    b[1:, :] |= label[:-1, :] != label[1:, :]
    b[:, :-1] |= label[:, :-1] != label[:, 1:]
    b[:, 1:] |= label[:, :-1] != label[:, 1:]
    return b


class Visualizer:

    def __init__(self, p_visu: str, store: bool = True, epoch: int = 0):
        self._p_visu = p_visu
        self._store = store
        self._epoch = epoch
        self._logger = None  # optional callable(tag, np_image)
        if store:
            for split in ("train_vis", "val_vis", "test_vis"):
                os.makedirs(os.path.join(p_visu, split), exist_ok=True)

    @property
    def epoch(self):
        return self._epoch

    @epoch.setter
    def epoch(self, epoch):
        self._epoch = epoch

    @property
    def store(self):
        return self._store

    @store.setter
    def store(self, store):
        self._store = store

    def set_logger(self, logger):
        self._logger = logger

    def _emit(self, img: np.ndarray, tag: str, store=None):
        store = self._store if store is None else store
        if store:
            p = os.path.join(self._p_visu, f"{tag}_epoch_{self._epoch}.png")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            write_png(p, img)
        if self._logger is not None:
            self._logger(tag, img)
        return img

    def plot_image(self, img, tag: str = "img", store=None):
        return self._emit(_to_uint8_image(img), tag, store)

    def plot_segmentation(self, seg, tag: str = "seg", store=None):
        return self._emit(colorize_label(seg), tag, store)

    def plot_detectron(self, img, label, tag: str = "detectron", alpha=0.6,
                       draw_bound=True, store=None):
        """Palette overlay on the image with class-boundary outlines and a
        per-image class legend (text-free variant of the reference's
        detectron-style plot)."""
        img = _to_uint8_image(img).astype(np.float32)
        label = np.asarray(label).astype(np.int64)
        overlay = colorize_label(label).astype(np.float32)
        out = (1 - alpha) * img + alpha * overlay
        if draw_bound:
            out[_class_boundaries(label)] = 255.0
        return self._emit(out.astype(np.uint8), tag, store)

    @staticmethod
    def class_name(class_id: int) -> str:
        if 0 <= class_id < len(SCANNET_CLASS_NAMES):
            return SCANNET_CLASS_NAMES[class_id]
        return f"class_{class_id}"
