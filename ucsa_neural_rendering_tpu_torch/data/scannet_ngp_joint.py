"""Joint-training scene dataset: NGP frames + replay + novel viewpoints
(counterpart of the JAX package's data/scannet_ngp_joint.py, the
reference's `ScanNetNGPJoint`, ref: nr4seg/dataset/scannet_ngp_joint.py:
23-508):
  * loads `transforms_train.json` per scene (NGP intrinsics, frame poses,
    `one_m_to_scene_uom`), applies `nerf_matrix_to_ngp` to every pose;
  * per-scene 80/20 train/val frame split by position in the frames list;
  * replay: with a replay buffer, each OLD scene contributes
    `replay_buffer_size // num_old_scenes` frames chosen by a seeded
    `random.Random(0).shuffle` (as the reference and the JAX package);
  * novel viewpoints: in predict mode, slerp-interpolated rotations +
    midpoint translations between consecutive train poses, dumped to
    `<scene>/<exp>/novel_viewpoints/interpolated_data.json` and consumed as
    replay sources in later stages;
  * three-way `collate` → (batch_old, batch_new, batch_cl).

Items are numpy: HWC f32 images in [0, 1], labels in the −1-ignore
convention, depth in metres, NGP poses; the trainer makes rays from pose
and intrinsics on the device. Files are read by the native loader
(data/native_loader.py: libjpeg / libpng and the area / nearest resize
in C++) where it is available, as the JAX package reads them, and
otherwise, or where it fails a file, through data/image_io.py (PNG in
numpy + zlib, JPEG through a library imported when a JPEG is read).
Old-scene items augment on the host (augmentation.host_augment) from an
int seed drawn from the dataset's numpy generator, as the JAX package's
do; `augment_params` (a callable (seed, hw, out_hw) → one
image's parameters) replaces the draw, e.g. to replay the JAX package's.
"""

import json
import os
import random
import re
from collections import defaultdict

import numpy as np

from . import native_loader
from .augmentation import host_augment
from .image_io import read_png, read_rgb, resize_area, resize_nearest
from .rays import nerf_matrix_to_ngp

VAL_SCENE_LIST = [f"scene{i:04d}_00" for i in range(10)]


class ScanNetNGPJoint:

    def __init__(self, root, scene_list, mode="train", output_size=(240, 320),
                 degrees=10, flip_p=0.5, jitter_bcsh=(0.3, 0.3, 0.3, 0.05),
                 data_augmentation=True, exp_name="debug",
                 use_novel_viewpoints=False, only_new_scene=True,
                 fix_nerf=False, replay_buffer_size=None, seed=0,
                 val_scene_list=None, augment_params=None):
        self._mode = mode
        self.H, self.W = output_size
        self.num_rays = 4096
        self.root = root
        self.exp_name = exp_name
        self.fix_nerf = fix_nerf
        self._data_augmentation = data_augmentation
        self._rng = np.random.default_rng(seed)
        self._augment_params = augment_params

        scene_list = list(scene_list)
        if only_new_scene:
            scene_list = [scene_list[-1]]

        self.replay_buffer_size = replay_buffer_size
        self.replay_per_scene = None
        if replay_buffer_size is not None:
            num_old = len(scene_list) - 1
            if num_old > 0:
                self.replay_per_scene = replay_buffer_size // num_old

        # val/train_val run over the fixed benchmark scene set (ref :66-93);
        # parameterized here so synthetic fixtures can use their own scenes.
        if mode in ("val", "train_val"):
            scene_list = (val_scene_list if val_scene_list is not None
                          else list(VAL_SCENE_LIST))

        if mode == "predict":
            self._use_novel_viewpoints = use_novel_viewpoints
        elif mode == "train":
            self._use_novel_viewpoints = (use_novel_viewpoints
                                          and self.replay_per_scene is not None)
        else:
            assert not use_novel_viewpoints
            self._use_novel_viewpoints = False

        self._gather_frames(scene_list)
        self.length = (len(self.nerf_image_pths) if self._use_novel_viewpoints
                       else len(self.image_pths))

    # ------------------------------------------------------------------ setup
    def _gather_frames(self, scene_list):
        self.poses = []
        self.image_pths, self.label_pths = [], []
        self.nerf_label_pths, self.nerf_image_pths = [], []
        self.depth_pths = []
        self.from_old_scene, self.viewpoint_is_novel = [], []

        for i, scene_name in enumerate(scene_list):
            scene_root = os.path.join(self.root, scene_name)
            tf_path = os.path.join(scene_root, "transforms_train.json")
            if not os.path.isfile(tf_path):
                raise FileNotFoundError(
                    f"{tf_path} not found — scene '{scene_name}' has not "
                    f"been preprocessed. Run preprocessing_scripts/"
                    f"scannet2transform.py and scannet2nerf.py on it first "
                    f"(see run_scripts/preprocess_scannet.sh).")
            with open(tf_path) as f:
                info = json.load(f)
            if i == len(scene_list) - 1:  # newest scene sets intrinsics
                self.ngp_H = int(info["h"])
                self.ngp_W = int(info["w"])
                self.one_m_to_scene_uom = info["one_m_to_scene_uom"]
                self.ngp_intrinsics = np.array(
                    [info["fl_x"], info["fl_y"], info["cx"], info["cy"]],
                    np.float32)

            frames = info["frames"]
            if self._mode != "predict":
                n_val = int(0.2 * len(frames))
                if self._mode == "val":
                    frames = frames[-n_val:] if n_val else []
                elif n_val:
                    frames = frames[:-n_val]

            novel_json = os.path.join(scene_root, self.exp_name,
                                      "novel_viewpoints",
                                      "interpolated_data.json")
            is_old_replay = (self._mode == "train"
                             and self.replay_per_scene is not None
                             and i < len(scene_list) - 1)
            if is_old_replay:
                if self._use_novel_viewpoints:
                    with open(novel_json) as f:
                        frames = json.load(f)["frames"]
                # seeded shuffle kept bit-identical with the reference
                # (random.Random(0), ref :162)
                random.Random(0).shuffle(frames)
                frames = frames[:self.replay_per_scene]

            current_poses, gen_img_paths, gen_label_paths = [], [], []
            for fr in frames:
                if is_old_replay and self._use_novel_viewpoints:
                    nerf_image_path = fr["nerf_image"]
                    nerf_label_path = fr["nerf_label"]
                    pose = np.array(fr["pose"], np.float32)
                else:
                    image_path = os.path.join(scene_root, fr["file_path"])
                    label_path = os.path.join(scene_root, fr["label_path"])
                    stem = os.path.basename(image_path).split(".")[0]
                    depth_path = os.path.join(scene_root, "depth",
                                              stem + ".png")
                    sub = ("novel_viewpoints" if self._use_novel_viewpoints
                           else "")
                    nerf_label_path = os.path.join(scene_root, self.exp_name,
                                                   sub, "nerf_label",
                                                   stem + ".png")
                    nerf_image_path = os.path.join(scene_root, self.exp_name,
                                                   sub, "nerf_image",
                                                   stem + ".png")
                    gen_label_paths.append(nerf_label_path)
                    gen_img_paths.append(nerf_image_path)
                    pose = np.array(fr["transform_matrix"], np.float32)
                current_poses.append(pose)

                novel = (self._use_novel_viewpoints
                         and (is_old_replay or self._mode == "predict"))
                self.viewpoint_is_novel.append(novel)
                if novel:
                    self.image_pths.append(None)
                    self.label_pths.append(None)
                    self.depth_pths.append(None)
                else:
                    self.image_pths.append(image_path)
                    self.label_pths.append(label_path)
                    self.depth_pths.append(depth_path)
                self.nerf_label_pths.append(nerf_label_path)
                self.nerf_image_pths.append(nerf_image_path)
                if self._mode in ("val", "train_val"):
                    self.from_old_scene.append(False)
                elif i < len(scene_list) - 1 or self.fix_nerf:
                    self.from_old_scene.append(True)
                else:
                    self.from_old_scene.append(False)

            if self._use_novel_viewpoints and self._mode == "predict":
                current_poses = self._interpolate_novel_poses(
                    current_poses, gen_img_paths, gen_label_paths, novel_json)

            self.poses.extend(nerf_matrix_to_ngp(p) for p in current_poses)

        # divergence from the reference: scenes with < 5 frames yield an
        # EMPTY val split (the reference's frames[-0:] would leak all frames
        # into val); an all-empty selection is legal and yields length 0
        self.poses = (np.stack(self.poses, axis=0) if self.poses
                      else np.zeros((0, 4, 4), np.float32))

    @staticmethod
    def _interpolate_novel_poses(current_poses, gen_img_paths,
                                 gen_label_paths, novel_json):
        """Slerp rotations + midpoint translations between consecutive train
        poses (closing the loop), written to interpolated_data.json
        (ref :229-286)."""
        from scipy.spatial.transform import Rotation, Slerp

        poses = list(current_poses) + [current_poses[0]]
        times = list(range(len(poses)))
        mid_times = [0.5 + k for k in range(len(poses) - 1)]
        slerp = Slerp(times, Rotation.from_matrix(
            [p[:3, :3] for p in poses]))
        rots = slerp(mid_times).as_matrix()
        out = []
        for k in range(len(poses) - 1):
            p = np.eye(4, dtype=np.float32)
            p[:3, :3] = rots[k]
            p[:3, 3] = (poses[k][:3, 3] + poses[k + 1][:3, 3]) / 2.0
            out.append(p)
        assert len(out) == len(gen_img_paths) == len(gen_label_paths)
        os.makedirs(os.path.dirname(novel_json), exist_ok=True)
        with open(novel_json, "w") as f:
            json.dump({"frames": [
                {"nerf_image": ip, "nerf_label": lp, "pose": p.tolist()}
                for ip, lp, p in zip(gen_img_paths, gen_label_paths, out)
            ]}, f, indent=2)
        return out

    # ------------------------------------------------------------- item utils
    def _read_rgb(self, path):
        out = native_loader.load_rgb(path, self.W, self.H)
        if out is not None:
            return out
        img = read_rgb(path).astype(np.float32) / 255.0
        return resize_area(img, (self.H, self.W))

    def _read_label(self, path):
        label = native_loader.load_label(path, self.W, self.H)
        if label is None:
            label = resize_nearest(read_png(path), (self.H, self.W))
        return label.astype(np.int64) - 1  # −1 unknown, 0..39

    def _read_depth(self, path):
        out = native_loader.load_depth(path, self.W, self.H)
        if out is not None:
            return out
        depth = read_png(path)
        if depth.dtype != np.uint16:
            raise ValueError(f"{path}: depth must be a 16-bit PNG")
        depth = resize_nearest(depth, (self.H, self.W))
        return depth.astype(np.float32) / 1000.0  # mm → m

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        novel = self.viewpoint_is_novel[index]
        if self.from_old_scene[index]:
            nerf_label = self._read_label(self.nerf_label_pths[index])
            nerf_image = self._read_rgb(self.nerf_image_pths[index])
            if novel:
                img, label, depth = nerf_image, nerf_label, None
            else:
                img = self._read_rgb(self.image_pths[index])
                label = self._read_label(self.label_pths[index])
                depth = self._read_depth(self.depth_pths[index])
            if self._mode == "train" and self._data_augmentation:
                # augment the NERF image together with both labels (+1 shift
                # so rotation fill 0 = unknown, ref :348-356)
                aimg, alabels = host_augment(
                    int(self._rng.integers(0, 2 ** 31)), nerf_image,
                    [(label + 1).astype(np.float32),
                     (nerf_label + 1).astype(np.float32)],
                    (self.H, self.W), only_crop=False,
                    params_fn=self._augment_params)
            else:
                # reference quirk kept for parity: the no-augmentation
                # branch crops the GT image `img`, not `nerf_image`
                # (ref scannet_ngp_joint.py:357-366)
                aimg, alabels = host_augment(
                    0, img, [(label + 1).astype(np.float32),
                             (nerf_label + 1).astype(np.float32)],
                    (self.H, self.W), only_crop=True)
            label = alabels[0].astype(np.int32) - 1
            nerf_label = alabels[1].astype(np.int32) - 1
            if novel:
                label = np.full_like(nerf_label, -1)
            pose = self.poses[index]
            ret = {
                "img": aimg.astype(np.float32), "label": label,
                "depth": (depth if depth is not None
                          else np.zeros((self.H, self.W), np.float32)),
                "nerf_label": nerf_label,
                "pose": pose.astype(np.float32),
                "from_old_scene": True, "viewpoint_is_novel": bool(novel),
            }
        else:
            if novel:
                img = np.zeros((self.H, self.W, 3), np.float32)
                label = np.full((self.H, self.W), -1, np.int32)
                depth = np.zeros((self.H, self.W), np.float32)
            else:
                img = self._read_rgb(self.image_pths[index])
                label = self._read_label(self.label_pths[index]).astype(
                    np.int32)
                depth = self._read_depth(self.depth_pths[index])
            ret = {
                "img": img.astype(np.float32), "label": label, "depth": depth,
                "nerf_label": label,
                "pose": self.poses[index].astype(np.float32),
                "from_old_scene": False, "viewpoint_is_novel": bool(novel),
            }

        ret.update({
            "H": self.ngp_H, "W": self.ngp_W,
            "intrinsics": self.ngp_intrinsics,
            "one_m_to_scene_uom": np.float32(self.one_m_to_scene_uom),
        })
        if novel:
            m = re.findall(r"scene\d\d\d\d_\d\d", self.nerf_image_pths[index])
            scene = m[0] if m else os.path.normpath(
                self.nerf_image_pths[index]).split(os.path.sep)[-4]
            idx_name = os.path.basename(self.nerf_image_pths[index])[:-4]
        else:
            scene = os.path.normpath(
                self.image_pths[index]).split(os.path.sep)[-3]
            idx_name = os.path.basename(self.image_pths[index])[:-4]
        ret["current_scene_name"] = scene
        ret["current_index"] = str(idx_name)
        return ret

    # ---------------------------------------------------------------- collate
    @staticmethod
    def collate(batch):
        """Three-way split: (batch_old, batch_new, batch_cl) (ref :460-495)."""
        from .loader import default_collate
        old, new, cl = [], [], defaultdict(list)
        for item in batch:
            cl_keys = {}
            for k in ("replay_img", "replay_label"):
                if k in item:
                    cl_keys[k] = item.pop(k)
            for k, v in cl_keys.items():
                cl[k].append(v)
            (old if item["from_old_scene"] else new).append(item)
        batch_old = default_collate(old) if old else None
        batch_new = default_collate(new) if new else None
        batch_cl = ({k: np.stack(v, 0) for k, v in cl.items()} if cl else None)
        return batch_old, batch_new, batch_cl
