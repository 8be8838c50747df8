"""Procedural 'cube room' test scene with analytic RGB / labels / depth
(counterpart of the JAX package's data/synthetic.py): cameras inside a
[-1,1]^3 room whose six walls have distinct colours and semantic classes;
ground truth from exact ray/box intersection, so the data layer and the
loops can run end to end with no ScanNet download.
`write_synthetic_scene_dir` emits the on-disk layout the reference's
preprocessing produces (transforms_train.json with NGP intrinsics and
one_m_to_scene_uom, color_scaled/, label_40_scaled/, depth/; ref:
preprocessing_scripts/scannet2transform.py,
nr4seg/dataset/scannet_ngp_joint.py:127-141,310-318), its colour frames
as JPEG (as the JAX package writes them) or PNG.
`write_synthetic_25k_dir` writes a scannet_frames_25k-style tree of the
same rooms for the ScanNet-25k dataset.
"""

import csv
import json
import os

import numpy as np

from .image_io import write_jpeg, write_png
from .rays import get_rays

WALL_RGB = np.array(
    [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9],
     [0.9, 0.9, 0.1], [0.1, 0.9, 0.9], [0.9, 0.1, 0.9]], np.float32)
# walls map to 6 distinct NYU classes: wall, floor, cabinet, bed, chair, sofa
WALL_CLASS = np.array([1, 2, 3, 4, 5, 6], np.int32) - 1  # 0-based labels


def scene_palette(variant: int = 0):
    """(wall_rgb [6,3], wall_class [6]) for a scene variant.

    Variant 0 is the historic fixture above (bit-compatible). Variants k>0
    mirror the structure of the reference's ScanNet protocol (SURVEY.md §6):
    rooms share a CLASS vocabulary but differ in appearance. Variants with
    the same `k % 7` form a FAMILY: identical six classes
    ((6*(k%7)..6*(k%7)+5) mod 40), same class-anchored base hues, but a
    per-variant color jitter — so a model pretrained on family twins (e.g.
    k+7) transfers imperfectly to scene k, exactly like a 25k-pretrained
    DeepLab on an unseen ScanNet room: decent pseudo-labels with headroom
    for adaptation, and cross-family forgetting that is measurable
    (scripts/exp_synthetic_cl.py)."""
    if variant == 0:
        return WALL_RGB.copy(), WALL_CLASS.copy()
    import colorsys
    set_id = variant % 7
    rng = np.random.default_rng(1234 + variant)
    hues = (set_id / 7.0 + np.arange(6) / 6.0
            + rng.uniform(-0.04, 0.04, 6)) % 1.0
    sat = rng.uniform(0.70, 0.95, 6)
    val = rng.uniform(0.75, 0.95, 6)
    rgb = np.array([colorsys.hsv_to_rgb(h, s, v)
                    for h, s, v in zip(hues, sat, val)], np.float32)
    classes = (WALL_CLASS + 6 * set_id) % 40
    return rgb, classes.astype(np.int32)


def _orbit_pose(angle: float, radius: float = 0.0) -> np.ndarray:
    """Camera at radius from center, yawed by angle, looking along +z of the
    rotated frame (NGP-style c2w)."""
    c, s = np.cos(angle), np.sin(angle)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    pose[:3, 3] = [radius * s * 0.5, 0.0, -radius * c * 0.5]
    return pose


def analytic_frame(pose: np.ndarray, intrinsics: np.ndarray, H: int, W: int,
                   one_m_to_scene_uom: float = 1.0, variant: int = 0):
    """Exact render of the cube room from `pose`.

    Returns (image [H,W,3] float in [0,1], label [H,W] int32 (6 distinct
    classes, `scene_palette(variant)`), depth [H,W] float32 z-depth in
    meters)."""
    wall_rgb, wall_class = scene_palette(variant)
    rays = get_rays(pose, intrinsics, H, W, device="cpu")
    o = rays["rays_o"].numpy().astype(np.float64)
    d = rays["rays_d"].numpy().astype(np.float64)
    dn = rays["direction_norms"].numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (1.0 - o) / d
        t0 = (-1.0 - o) / d
    t_far = np.minimum(np.maximum(t0, t1).min(-1), 1e9)
    p = o + t_far[:, None] * d
    axis = np.abs(p).argmax(-1)
    sign = np.take_along_axis(p, axis[:, None], 1)[:, 0] > 0
    wall = axis * 2 + sign
    image = wall_rgb[wall].reshape(H, W, 3)
    label = wall_class[wall].reshape(H, W)
    depth = (t_far / dn / one_m_to_scene_uom).reshape(H, W).astype(np.float32)
    return image, label.astype(np.int32), depth


def make_synthetic_scene(n_frames: int = 6, H: int = 32, W: int = 40,
                         one_m_to_scene_uom: float = 1.0, variant: int = 0,
                         frame_gain: float = 0.0, pixel_noise: float = 0.0):
    """Returns (frames, intrinsics): frames is a list of dicts with pose /
    image / label / depth, poses yaw-orbiting inside the room.

    `frame_gain` / `pixel_noise` add per-FRAME exposure variation
    (gain ~ U(1−g, 1+g)) and per-pixel Gaussian noise — the view-dependent
    appearance variation real captures have. With them, a seg model's
    pseudo-label errors differ per view, so the NeRF's multi-view fusion
    has something to denoise (the paper's central mechanism); the analytic
    labels/depth stay exact."""
    intrinsics = np.array([0.75 * W, 0.75 * W, W / 2, H / 2], np.float32)
    frames = []
    for k in range(n_frames):
        pose = _orbit_pose(2 * np.pi * k / n_frames, radius=0.4)
        image, label, depth = analytic_frame(pose, intrinsics, H, W,
                                             one_m_to_scene_uom, variant)
        if frame_gain or pixel_noise:
            rng = np.random.default_rng(9000 + 1000 * variant + k)
            g = rng.uniform(1.0 - frame_gain, 1.0 + frame_gain)
            image = image * g
            if pixel_noise:
                image = image + rng.normal(0.0, pixel_noise, image.shape)
            image = np.clip(image, 0.0, 1.0).astype(np.float32)
        frames.append({"pose": pose, "image": image, "label": label,
                       "depth": depth})
    return frames, intrinsics


def write_synthetic_scene_dir(root: str, scene_name: str = "scene0000_00",
                              n_frames: int = 6, H: int = 32, W: int = 40,
                              one_m_to_scene_uom: float = 1.0,
                              variant: int = 0, frame_gain: float = 0.0,
                              pixel_noise: float = 0.0,
                              color_ext: str = ".jpg"):
    """Emit a ScanNet-NGP-format scene directory for data-pipeline tests.

    Layout (matches what the reference's preprocessing produces and its
    datasets consume):
      <root>/<scene_name>/transforms_train.json   (fl_x..cy, w, h,
          one_m_to_scene_uom, frames[{file_path, label_path,
          transform_matrix}])
      <root>/<scene_name>/color_scaled/N<color_ext>  (".jpg" at quality
          98, as the JAX package writes it, or ".png")
      <root>/<scene_name>/label_40_scaled/N.png   (stored class+1, uint8)
      <root>/<scene_name>/depth/N.png             (uint16 millimeters)

    NOTE: transform_matrix holds the pre-NGP pose (datasets apply
    nerf_matrix_to_ngp on load, ref scannet_ngp_joint.py:288), so here we
    store the INVERSE permutation of our NGP-convention orbit pose.
    """
    if color_ext not in (".jpg", ".png"):
        raise ValueError(f"color_ext must be '.jpg' or '.png', not "
                         f"{color_ext!r}")
    scene_root = os.path.join(root, scene_name)
    for sub in ("color_scaled", "label_40_scaled", "label_scaled",
                "mapping_label", "depth"):
        os.makedirs(os.path.join(scene_root, sub), exist_ok=True)

    frames, intrinsics = make_synthetic_scene(n_frames, H, W,
                                              one_m_to_scene_uom, variant,
                                              frame_gain, pixel_noise)
    meta = {
        "fl_x": float(intrinsics[0]), "fl_y": float(intrinsics[1]),
        "cx": float(intrinsics[2]), "cy": float(intrinsics[3]),
        "w": W, "h": H, "aabb_scale": 16,
        "one_m_to_scene_uom": one_m_to_scene_uom,
        "frames": [],
    }
    for k, fr in enumerate(frames):
        name = str(k)
        color = (fr["image"] * 255).astype(np.uint8)
        color_path = os.path.join(scene_root, "color_scaled", name + color_ext)
        if color_ext == ".jpg":
            write_jpeg(color_path, color, quality=98)
        else:
            write_png(color_path, color)
        for label_dir in ("label_40_scaled", "label_scaled", "mapping_label"):
            write_png(os.path.join(scene_root, label_dir, name + ".png"),
                      (fr["label"] + 1).astype(np.uint8))
        write_png(os.path.join(scene_root, "depth", name + ".png"),
                  (fr["depth"] * 1000).astype(np.uint16))
        # invert nerf_matrix_to_ngp: rows (1,2,0)→(0,1,2) means stored row r
        # comes from ngp row; reverse permutation is rows (2,0,1) with the
        # same column negations.
        p = fr["pose"]
        stored = np.array([
            [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3]],
            [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3]],
            [p[1, 0], -p[1, 1], -p[1, 2], p[1, 3]],
            [0, 0, 0, 1],
        ], np.float32)
        meta["frames"].append({
            "file_path": f"color_scaled/{name}{color_ext}",
            "label_path": f"label_40_scaled/{name}.png",
            "transform_matrix": stored.tolist(),
        })
    with open(os.path.join(scene_root, "transforms_train.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return scene_root


def write_synthetic_25k_dir(root: str, n_scenes: int = 2,
                            n_frames_per_scene: int = 4, H: int = 48,
                            W: int = 64, variants=None,
                            frame_gain: float = 0.0,
                            pixel_noise: float = 0.0):
    """Emit a scannet_frames_25k-style tree for pretrain / replay tests, as
    the JAX package's writer does:
      <root>/scene####_00/color/N.jpg   (JPEG at quality 95)
      <root>/scene####_00/label/N.png   (uint8 FAST labels, class + 1)
      <root>/scannetv2-labels.combined.tsv  (id → nyu40id, identity 1..40)
    `variants`: an optional `scene_palette` variant a scene (default 0 for
    all). Returns the colour paths."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "scannetv2-labels.combined.tsv"), "w",
              newline="") as f:
        out = csv.writer(f, delimiter="\t", lineterminator="\n")
        out.writerow(["id", "nyu40id", "raw_category"])
        out.writerows([i, i, f"c{i}"] for i in range(1, 41))

    paths = []
    intr = np.array([0.75 * W, 0.75 * W, W / 2, H / 2], np.float32)
    for s in range(n_scenes):
        scene = f"scene{s:04d}_00"
        os.makedirs(os.path.join(root, scene, "color"), exist_ok=True)
        os.makedirs(os.path.join(root, scene, "label"), exist_ok=True)
        variant = 0 if variants is None else variants[s]
        rng = np.random.default_rng(7000 + 100 * s)
        for k in range(n_frames_per_scene):
            pose = _orbit_pose(2 * np.pi * (k + s) / n_frames_per_scene, 0.4)
            img, lab, _ = analytic_frame(pose, intr, H, W, variant=variant)
            if frame_gain or pixel_noise:
                g = rng.uniform(1.0 - frame_gain, 1.0 + frame_gain)
                img = np.clip(img * g + rng.normal(0.0, pixel_noise,
                                                   img.shape),
                              0.0, 1.0).astype(np.float32)
            p = os.path.join(root, scene, "color", f"{k}.jpg")
            write_jpeg(p, (img * 255).astype(np.uint8), quality=95)
            write_png(os.path.join(root, scene, "label", f"{k}.png"),
                      (lab + 1).astype(np.uint8))
            paths.append(p)
    return paths
