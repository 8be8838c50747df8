"""Per-scene NeRF-render dataset, the finetune loop's training and
validation set (a port of the JAX package's data/scannet_ngp.py, the
reference's `ScanNetNGP`, ref: nr4seg/dataset/scannet_ngp.py:17-202):
  * a scene's `color_scaled/*.jpg` frames sorted by integer frame index,
    the first 80 % the train split (every `sub`-th), the last 20 % val;
  * train sources: `train_image` "gt" (the frame), "nerf" (the NeRF-only
    stage's render `<prev_exp_name>/nerf_image/N.png`) or "half" (one of
    the two by a coin); `train_label` "nerf" (`<prev_exp_name>/nerf_label`)
    or anything else for `mapping_label`;
  * val modes: "gtgt" (frame, `label_scaled`), "nerfgt" (render,
    `label_scaled`), "nerfnerf" (render, NeRF label);
  * RGB read and resized by area, labels by nearest neighbour, to
    output_size, by the native loader (data/native_loader.py) where it is
    available, as the JAX package reads them, else (or where it fails a
    file) by image_io.read_rgb / read_png and their resizes; then
    augmentation.host_augment (a centre crop outside training) and the
    −1 label shift.

Label convention: `label_scaled` and `mapping_label` store NYU ids 0..40
(0 = unlabelled), and the predict dumps store class + 1; both shift by −1
on load, as the JAX package does (the reference adds +1 to NeRF labels
before its common −1, scannet_ngp.py:164-166, which would leave them in
1..40 and overflow a 40-way loss).

Draws: one np.random.default_rng(seed) stream per dataset, drawn in the
JAX package's order for each item: the "half" coin first (train mode with
train_image "half"), then the augmentation seed (every item, every mode;
unused by the centre crop). Items are (img [H, W, 3] f32 in [0, 1], label
[H, W] int32, img) and, outside training, the scene name as a 4th element.
`augment_params` replaces the augmentation draw, e.g. to replay the JAX
package's.
"""

import os
from glob import glob

import numpy as np

from . import native_loader
from .augmentation import host_augment
from .image_io import read_png, read_rgb, resize_area, resize_nearest

TRAIN_IMAGES = ("gt", "nerf", "half")
VAL_MODES = ("gtgt", "nerfgt", "nerfnerf")


class ScanNetNGP:

    def __init__(self, root, scene_list, prev_exp_name="one_step_nerf_only",
                 mode="train", train_image="nerf", train_label="nerf",
                 val_mode="gtgt", output_size=(240, 320), sub=1,
                 data_augmentation=True, seed=0, augment_params=None):
        if mode == "train" and train_image not in TRAIN_IMAGES:
            raise ValueError(f"train_image={train_image!r}: expected one of "
                             f"{TRAIN_IMAGES}")
        if mode != "train" and val_mode not in VAL_MODES:
            raise ValueError(f"val_mode={val_mode!r}: expected one of "
                             f"{VAL_MODES}")
        self._mode = mode
        self._sub = sub
        self.H, self.W = output_size
        self.root = root
        self.train_image = train_image
        self.train_label = train_label
        self.val_mode = val_mode
        self._data_augmentation = data_augmentation
        self._augment_params = augment_params
        self._rng = np.random.default_rng(seed)

        self.image_pths, self.img_num = self._get_image_pths(scene_list)

        def swap(p, folder):
            return p.replace("color_scaled", folder).replace(".jpg", ".png")

        self.image_gt_pths = self.image_pths
        self.image_nerf_pths = [
            swap(p, os.path.join(prev_exp_name, "nerf_image"))
            for p in self.image_pths]
        self.label_nerf_pths = [
            swap(p, os.path.join(prev_exp_name, "nerf_label"))
            for p in self.image_pths]
        self.label_mapping_pths = [swap(p, "mapping_label")
                                   for p in self.image_pths]
        self.label_gt_pths = [swap(p, "label_scaled")
                              for p in self.image_pths]

    def _get_image_pths(self, scene_list, val_ratio=0.2):
        """A scene's frames sorted by index; val = the last 20 % (ref
        :90-106). Returns (paths, train frames a scene)."""
        img_list, img_num = [], []
        for scene_name in scene_list:
            all_imgs = sorted(
                glob(os.path.join(self.root, scene_name, "color_scaled",
                                  "*jpg")),
                key=lambda x: int(os.path.basename(x)[:-4]))
            n_val = int(len(all_imgs) * val_ratio)
            if self._mode == "train":
                sel = all_imgs[:-n_val] if n_val else all_imgs
                sel = sel[::self._sub]
                img_num.append(len(sel))
            else:
                sel = all_imgs[-n_val:][::self._sub] if n_val else []
            img_list.extend(sel)
        return img_list, img_num

    def __len__(self):
        return len(self.image_pths)

    def _read_rgb(self, path):
        out = native_loader.load_rgb(path, self.W, self.H)
        if out is not None:
            return out
        img = read_rgb(path).astype(np.float32) / 255.0
        return resize_area(img, (self.H, self.W))

    def _read_label(self, path):
        """The stored label plane (0 unlabelled, class + 1) as f32."""
        label = native_loader.load_label(path, self.W, self.H)
        if label is None:
            label = resize_nearest(read_png(path), (self.H, self.W))
        return label.astype(np.float32)

    def _sources(self, index):
        """(image path, label path) of an item; draws the "half" coin."""
        if self._mode == "train":
            if self.train_image == "gt":
                img = self.image_gt_pths[index]
            elif self.train_image == "nerf":
                img = self.image_nerf_pths[index]
            else:
                img = (self.image_gt_pths[index] if self._rng.random() > 0.5
                       else self.image_nerf_pths[index])
            label = (self.label_nerf_pths[index]
                     if self.train_label == "nerf"
                     else self.label_mapping_pths[index])
        else:
            img = (self.image_gt_pths[index] if self.val_mode == "gtgt"
                   else self.image_nerf_pths[index])
            label = (self.label_nerf_pths[index]
                     if self.val_mode == "nerfnerf"
                     else self.label_gt_pths[index])
        return img, label

    def plan(self, index):
        """The item's draws from the dataset's stream, in __getitem__'s
        order, without reading: (image path, label path, augmentation
        seed). Split loading (data/loader.py) plans every item of a global
        batch and loads only its own."""
        img_path, label_path = self._sources(index)
        return img_path, label_path, int(self._rng.integers(0, 2 ** 31))

    def __getitem__(self, index):
        return self.load(index, self.plan(index))

    def load(self, index, plan):
        img_path, label_path, seed = plan
        img = self._read_rgb(img_path)
        label = self._read_label(label_path)
        train = self._mode == "train" and self._data_augmentation
        img, labels = host_augment(seed, img,
                                   [label], (self.H, self.W),
                                   only_crop=not train,
                                   params_fn=self._augment_params)
        label = labels[0].astype(np.int64) - 1
        img = img.astype(np.float32)
        ret = (img, label.astype(np.int32), img)
        if self._mode != "train":
            ret += (os.path.normpath(self.image_pths[index]).split(
                os.path.sep)[-3],)
        return ret
