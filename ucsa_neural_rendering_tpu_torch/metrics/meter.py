"""Semantic-segmentation metrics with the confusion matrix on the device
(counterpart of ucsa_neural_rendering_tpu/metrics/meter.py).

The reference's SemanticsMeter gathers pixel tensors to the host for
sklearn; here each update is one `torch.bincount` on the device, and only
the C×C matrix ever reaches the host. Updates accumulate in an int32 device
window with no synchronisation and fold into a host int64 total every 32
updates and at `measure()`: a window fits int32, a 25k-frame evaluation
(~10^10 pixels) would wrap one. `measure()` is the reference's metric
math: mIoU over the classes present in the ground truth, total accuracy
and mean class accuracy, with -1 pixels ignored.

Under a mesh (`SemanticsMeter(C, mesh)`, JAX `meter.py:8, 101`, where the
matrix is psum'd) each rank's `update` of its block all-reduces the C × C
matrix, so every rank holds the global count; `update_confmat` takes a
matrix that is global already (SegTrainer.train_step's).
"""

import numpy as np
import torch


def confusion_matrix_update(preds: torch.Tensor, truths: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """C×C int32 confusion matrix of one batch on the tensors' device;
    rows = truth, cols = pred (clamped into range). Truths of -1 (ignore)
    or out of range go to an overflow bin that is dropped."""
    preds = preds.reshape(-1).long()
    truths = truths.reshape(-1).long()
    valid = (truths >= 0) & (truths < num_classes)
    idx = torch.where(valid,
                      truths * num_classes + preds.clamp(0, num_classes - 1),
                      num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes).to(torch.int32)


def measure_from_confmat(conf_mat: np.ndarray):
    """(mIoU over existing classes, total accuracy, mean class accuracy);
    classes absent from the ground truth (row sum 0) are left out of mIoU
    and of the mean class accuracy."""
    conf_mat = np.asarray(conf_mat, dtype=np.float64)
    num_classes = conf_mat.shape[0]
    row_sums = conf_mat.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm_conf_mat = conf_mat / row_sums[:, None]
    existing = row_sums > 0

    diag = np.diagonal(norm_conf_mat)
    class_average_accuracy = np.mean(diag[existing]) if existing.any() \
        else float("nan")
    total = conf_mat.sum()
    total_accuracy = np.diagonal(conf_mat).sum() / total if total > 0 \
        else float("nan")

    ious = np.zeros(num_classes)
    for c in range(num_classes):
        denom = conf_mat[c, :].sum() + conf_mat[:, c].sum() - conf_mat[c, c]
        ious[c] = conf_mat[c, c] / denom if denom > 0 else 0.0
    miou = np.mean(ious[existing]) if existing.any() else float("nan")
    return float(miou), float(total_accuracy), float(class_average_accuracy)


class SemanticsMeter:
    """The reference's clear / update / measure interface over a device
    confusion matrix (module docstring)."""

    # device window before a fold into host int64: 32 × a 2·10^7-pixel
    # update stays ~3× under an int32 cell's 2^31
    _FOLD_EVERY = 32

    def __init__(self, number_classes: int, mesh=None):
        self.number_classes = number_classes
        self.mesh = mesh
        self.clear()

    def clear(self):
        self._host = None  # folded int64 running total
        self._dev = None  # int32 device window
        self._pending = 0

    def update(self, preds: torch.Tensor, truths: torch.Tensor):
        conf = confusion_matrix_update(preds, truths, self.number_classes)
        if self.mesh is not None:
            conf = self.mesh.all_reduce_(conf)
        self.update_confmat(conf)

    def update_confmat(self, conf_mat: torch.Tensor):
        """Accumulate a precomputed C×C matrix (e.g. summed across
        ranks)."""
        self._dev = conf_mat if self._dev is None else self._dev + conf_mat
        self._pending += 1
        if self._pending >= self._FOLD_EVERY:
            self._fold()

    def _fold(self):
        if self._dev is not None:
            d = self._dev.cpu().numpy().astype(np.int64)
            self._host = d if self._host is None else self._host + d
            self._dev = None
        self._pending = 0

    @property
    def conf_mat(self):
        """The folded int64 running total (forces a fold); None when
        empty."""
        self._fold()
        return self._host

    def measure(self):
        self._fold()
        if self._host is None:
            raise ValueError("measure() called on an empty meter")
        return measure_from_confmat(self._host)
