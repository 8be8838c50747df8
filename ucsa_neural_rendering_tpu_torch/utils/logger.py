"""Experiment logging (counterpart of the JAX package's utils/logger.py).

The reference logs scalars and images to WandB (with Neptune / TensorBoard
fallbacks, ref: nr4seg/utils/get_logger.py:17-52). The sink here is a JSONL
file, and TensorBoard when asked for; images go to PNG files through
data/image_io.py. Unlike the JAX package, the logger never tries wandb: the
machines the port runs on have no network, a failed `wandb.init` makes a
login attempt, and wandb keeps the failure's traceback, whose frames pin
the calling stage's locals (its whole trainer on the card) for the life of
the process.
"""

import json
import os
import time

import numpy as np

from ..data.image_io import write_png


class MetricsLogger:
    """Scalar logger: JSONL on disk + optional TensorBoard. project_name
    (the reference's wandb project) is accepted and unused."""

    def __init__(self, save_dir: str, project_name: str = "",
                 use_tensorboard: bool = False,
                 exp_config: dict | None = None):
        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        self._jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        self._step = 0
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=os.path.join(save_dir, "tb"))
            except Exception:
                self._tb = None
        self._img_seq = {}  # per-tag monotonic index for image filenames
        if exp_config:
            with open(os.path.join(save_dir, "hparams.json"), "w") as f:
                json.dump(exp_config, f, indent=2, default=str)

    def log(self, metrics: dict, step: int | None = None):
        if step is None:
            step = self._step
            self._step += 1
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def log_image(self, tag: str, image, step: int | None = None):
        """Log one HWC uint8 image: a PNG under save_dir/images (always) +
        TensorBoard when attached. The filename carries a per-tag
        monotonic index, so that repeated logs of one tag at one scalar step
        do not overwrite each other."""
        image = np.asarray(image)
        if step is None:
            step = self._step
        seq = self._img_seq.get(tag, 0)
        self._img_seq[tag] = seq + 1
        safe = tag.replace("/", "_")
        d = os.path.join(self.save_dir, "images")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{safe}_step_{step}_{seq:04d}.png"), image)
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")

    def log_hyperparams(self, hparams: dict):
        with open(os.path.join(self.save_dir, "hparams_flat.json"), "w") as f:
            json.dump(hparams, f, indent=2, default=str)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()



class NullLogger:
    """MetricsLogger's interface writing nothing: the logger of every rank
    but rank 0 under a mesh (rank 0 logs)."""

    def log(self, metrics: dict, step: int | None = None):
        pass

    def log_image(self, tag: str, image, step: int | None = None):
        pass

    def log_hyperparams(self, hparams: dict):
        pass

    def close(self):
        pass
