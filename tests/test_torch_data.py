"""The port's data layer against the JAX package's (and cv2's), on the CPU.

  * PNG (numpy + zlib) against cv2.imread(..., IMREAD_UNCHANGED): exact, on
    grey 8-bit, RGB, RGBA and 16-bit depth files, each of the five row
    filters, and cv2 reads the port's files back exactly;
  * JPEG against cv2: max |Δ| ≤ 1 level on ≥ 0.99 of the samples
    (measured: 0, with PIL 12.1 against cv2 5.0, which decode the same
    bits; the port's JPEG files are imageio's byte for byte);
  * resizes against cv2 at integer factors: INTER_AREA within 1e-6,
    INTER_NEAREST exact;
  * DataLoader batch orders, splits, the synthetic scene: exact;
  * ScanNetNGPJoint items against the JAX package's, field by field, on a
    two-scene fixture: exact where the colour frames are PNG; JPEG colour
    within JPEG_TOL of the JAX dataset's read (which goes through the
    native loader or cv2); old-scene items, augmented with JAX's draws
    replayed, within 1e-5 (images) and equal on ≥ 0.999 of the label
    pixels (rotation near-ties, tests/test_torch_augmentation.py).
"""

import copy
import json
import os
import struct
import sys
import zlib

import cv2
import jax
import numpy as np
import pytest

from test_torch_augmentation import jax_params, stack
from ucsa_neural_rendering_tpu.data import loader as jloader
from ucsa_neural_rendering_tpu.data import scannet_ngp_joint as jds
from ucsa_neural_rendering_tpu.data import splits as jsplits
from ucsa_neural_rendering_tpu.data import synthetic as jsyn
from ucsa_neural_rendering_tpu.train import joint_loop as jloop
from ucsa_neural_rendering_tpu_torch.data import image_io as io
from ucsa_neural_rendering_tpu_torch.data import loader as tloader
from ucsa_neural_rendering_tpu_torch.data import scannet_ngp_joint as tds
from ucsa_neural_rendering_tpu_torch.data import splits as tsplits
from ucsa_neural_rendering_tpu_torch.data import synthetic as tsyn
from ucsa_neural_rendering_tpu_torch.train import joint_loop as tloop

H, W = 24, 32
SCENES = ["scene0000_00", "scene0001_00"]
# JPEG colour through the port (its first importable decoder) against the
# JAX dataset's read (its native loader or cv2): max |Δ| in [0, 1] units,
# share of samples that may differ at all (measured: 0 and 0)
JPEG_TOL = (1.0 / 255 + 1e-6, 0.01)


# ------------------------------------------------------------------ PNG
def _filter_row(kind, cur, prior, bpp):
    cur, prior = cur.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((cur - pred) % 256).astype(np.uint8)


def _png(img, filters, color=None, interlace=0, depth=None):
    """A PNG whose rows use the given filter types in turn (a reference
    encoder, independent of the port's)."""
    img = np.asarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = np.ascontiguousarray(img.astype(">u2") if img.dtype == np.uint16
                                else img).view(np.uint8).reshape(
                                    img.shape[0], -1)
    bpp = ch * img.dtype.itemsize
    prior = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y, row in enumerate(rows):
        kind = filters[y % len(filters)]
        raw += bytes([kind]) + _filter_row(kind, row, prior, bpp).tobytes()
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    color = {1: 0, 3: 2, 4: 6}[ch] if color is None else color
    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0],
                         depth or 8 * img.dtype.itemsize, color, 0, 0,
                         interlace)
    return (io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _cv2_unchanged(path):
    """cv2's read, in the file's RGB(A) order."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _images():
    rng = np.random.default_rng(0)
    smooth = np.cumsum(np.cumsum(rng.uniform(0, 1, (40, 56, 3)), 0), 1)
    return {
        "grey8": rng.integers(0, 256, (40, 56), dtype=np.uint8),
        "label": rng.integers(0, 41, (40, 56), dtype=np.uint8),
        "rgb8": (smooth / smooth.max() * 255).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (40, 56, 4), dtype=np.uint8),
        "depth16": (smooth[..., 0] / smooth.max() * 65535).astype(np.uint16),
    }


@pytest.mark.parametrize("name", list(_images()))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4), "cv2"])
def test_png_decode_matches_cv2(tmp_path, name, filters):
    """Every filter type alone and mixed row by row, and cv2's own file
    (libpng's adaptive filters): the port's read equals cv2's."""
    img = _images()[name]
    path = tmp_path / "x.png"
    if filters == "cv2":
        bgr = img if img.ndim == 2 else _cv2_unchanged_order(img)
        assert cv2.imwrite(str(path), bgr)
    else:
        path.write_bytes(_png(img, filters))
    ref = _cv2_unchanged(path)
    got = io.read_png(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


def _cv2_unchanged_order(img):
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


@pytest.mark.parametrize("name", list(_images()))
def test_png_encode_reads_back_in_cv2(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / "x.png")
    io.write_png(path, img)
    np.testing.assert_array_equal(_cv2_unchanged(path), img)
    np.testing.assert_array_equal(io.read_png(path), img)


@pytest.mark.parametrize("case", ["interlaced", "paletted", "grey_alpha",
                                  "depth_4", "bad_crc", "not_png",
                                  "float_samples"])
def test_png_refuses_what_it_does_not_read(tmp_path, case):
    img = _images()["grey8"]
    data = {"interlaced": lambda: _png(img, (0,), interlace=1),
            "paletted": lambda: _png(img, (0,), color=3),
            "grey_alpha": lambda: _png(img, (0,), color=4),
            "depth_4": lambda: _png(img, (0,), depth=4),
            "bad_crc": lambda: _png(img, (0,))[:-5] + b"\x00\x00\x00\x00\x00",
            "not_png": lambda: b"\xff\xd8\xff\xe0 a jpeg"}
    with pytest.raises(ValueError):
        if case == "float_samples":
            io.encode_png(img.astype(np.float32))
        else:
            io.decode_png(data[case]())


@pytest.mark.parametrize("quality", [90, 98])
@pytest.mark.parametrize("writer", ["cv2", "port"])
def test_jpeg_read_matches_cv2(tmp_path, quality, writer):
    """The port's JPEG read (the first of torchvision, PIL, cv2 that
    imports) against cv2's, RGB: within 1 level on ≥ 0.99 of the samples
    (measured 0); read_rgb and read_image take it by its bytes."""
    rgb = _images()["rgb8"]
    path = str(tmp_path / "x.jpg")
    if writer == "cv2":
        cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    else:
        io.write_jpeg(path, rgb, quality)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1].astype(np.int64)
    got = io.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    d = np.abs(got.astype(np.int64) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    np.testing.assert_array_equal(io.read_rgb(path), got)
    assert np.abs(got.astype(np.int64) - rgb).mean() < 3  # it is the image


def test_jpeg_needs_a_decoder(monkeypatch, tmp_path):
    """With none of torchvision, PIL and cv2 importable, a JPEG read raises
    ImportError naming them (no silent substitute)."""
    for name in ("torchvision", "torchvision.io", "PIL", "PIL.Image",
                 "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    path = str(tmp_path / "x.jpg")
    with pytest.raises(ImportError, match="torchvision.*PIL.*cv2"):
        io.read_jpeg(path)
    with pytest.raises(ImportError, match="torchvision.*PIL.*cv2"):
        io.write_jpeg(path, _images()["rgb8"])


@pytest.mark.parametrize("out", [(48, 64), (24, 32), (16, 32), (12, 8),
                                 (30, 40), (17, 23)])
def test_resizes_match_cv2(out):
    """INTER_AREA of a float image within 1e-6 and INTER_NEAREST of uint8
    labels and uint16 depth exactly, from 48×64 at integer downscale
    factors (the identity at 1) and at two others (measured ≤ 1.2e-7)."""
    rng = np.random.default_rng(1)
    h, w = 48, 64
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    ref = cv2.resize(img, out[::-1], interpolation=cv2.INTER_AREA)
    got = io.resize_area(img, out)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    for a in (rng.integers(0, 41, (h, w)).astype(np.uint8),
              rng.integers(0, 65535, (h, w)).astype(np.uint16)):
        np.testing.assert_array_equal(
            io.resize_nearest(a, out),
            cv2.resize(a, out[::-1], interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError, match="downscales only"):
        io.resize_area(img, (h * 2, w))


# ---------------------------------------------------------------- loader
class _Items:
    def __init__(self, n):
        self.n, self.epochs = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full((2, 3), i, np.float32),
                "name": f"f{i}", "pair": (np.float32(i), None)}

    def set_epoch(self, e):
        self.epochs.append(e)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("shuffle,drop_last,batch",
                         [(True, True, 4), (True, False, 3),
                          (False, False, 4), (True, False, 1)])
def test_data_loader_batches_match_jax(seed, shuffle, drop_last, batch):
    """Batch orders and collated batches for epochs 0, 1 and 5 (pinned
    with set_epoch, as a resumed run pins them), with and without the
    prefetch thread; len; set_epoch reaches the dataset."""
    for prefetch in (2, 0):
        loaders = [mod.DataLoader(_Items(10), batch_size=batch,
                                  shuffle=shuffle, drop_last=drop_last,
                                  seed=seed, prefetch=prefetch)
                   for mod in (tloader, jloader)]
        assert len(loaders[0]) == len(loaders[1])
        for epoch in (0, 1, 5):
            for dl in loaders:
                dl.set_epoch(epoch)
            got, ref = (list(dl) for dl in loaders)
            assert len(got) == len(ref) == len(loaders[0])
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a["i"], b["i"])
                np.testing.assert_array_equal(a["x"], b["x"])
                assert a["name"] == b["name"]
                np.testing.assert_array_equal(a["pair"][0], b["pair"][0])
                assert a["pair"][1] is None and b["pair"][1] is None
        assert loaders[0].dataset.epochs == loaders[1].dataset.epochs


def test_data_loader_raises_a_worker_error():
    class Bad(_Items):
        def __getitem__(self, i):
            raise KeyError(i)
    with pytest.raises(KeyError):
        list(tloader.DataLoader(Bad(3)))


def test_splits_match_jax(tmp_path):
    for s in range(3):
        d = tmp_path / f"scene{s:04d}_00" / "color"
        d.mkdir(parents=True)
        for k in range(7):
            (d / f"{k}.jpg").write_bytes(b"")
    for seed in (0, 5):
        got = tsplits.create_split(str(tmp_path), val_ratio=0.3, seed=seed)
        ref = jsplits.create_split(str(tmp_path), val_ratio=0.3, seed=seed)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    out = str(tmp_path / "s" / "split.npz")
    tsplits.save_split(got, out)
    for k, v in jsplits.load_split(out).items():
        np.testing.assert_array_equal(v, got[k])
        np.testing.assert_array_equal(tsplits.load_split(out)[k], v)


@pytest.mark.parametrize("kw", [{}, {"variant": 3, "frame_gain": 0.1,
                                     "pixel_noise": 0.02,
                                     "one_m_to_scene_uom": 0.7}])
def test_synthetic_scene_matches_jax(kw):
    """make_synthetic_scene on the port's get_rays: poses, images, labels
    and depth equal to the JAX package's."""
    ft, it = tsyn.make_synthetic_scene(4, H, W, **kw)
    fj, ij = jsyn.make_synthetic_scene(4, H, W, **kw)
    np.testing.assert_array_equal(it, ij)
    for a, b in zip(ft, fj):
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------- the datasets
def _fake_outputs(seed):
    rng = np.random.default_rng(seed)
    return {"nerf_rgb": rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32),
            "nerf_semantics": rng.integers(0, 40, (H, W)),
            "seg_semantics": rng.integers(0, 40, (H, W))}


def _dump(write, root, scene, exp_name, novel=False):
    """Predict dumps of every frame of `scene` under exp_name (the novel
    viewpoints' with novel), from seeded fake outputs."""
    folder = os.path.join(root, scene, exp_name)
    write_dirs = (tloop.make_predict_dirs if write is
                  tloop.write_predict_outputs else jloop.make_predict_dirs)
    if not os.path.isdir(os.path.join(folder, "nerf_image")):
        write_dirs(folder)
    n = len(json.load(open(os.path.join(root, scene,
                                        "transforms_train.json")))["frames"])
    for k in range(n):
        write(folder, {"viewpoint_is_novel": novel, "current_index": str(k)},
              _fake_outputs(100 * novel + k))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Two scenes of 5 frames at 24×32 three times: written by JAX's
    writer (JPEG colour), by the port's with PNG colour, and by the port's
    with JPEG colour; predict dumps of scene 0 (normal and novel views)
    under exp "dumps" in the first two, written by JAX's
    write_predict_outputs."""
    base = tmp_path_factory.mktemp("scenes")
    roots = {}
    for name, write, kw in (("jax", jsyn.write_synthetic_scene_dir, {}),
                            ("port_png", tsyn.write_synthetic_scene_dir,
                             {"color_ext": ".png"}),
                            ("port_jpg", tsyn.write_synthetic_scene_dir,
                             {})):
        roots[name] = str(base / name)
        for s, scene in enumerate(SCENES):
            write(roots[name], scene, n_frames=5, H=H, W=W, variant=s, **kw)
    for name in ("jax", "port_png"):
        for novel in (False, True):
            _dump(jloop.write_predict_outputs, roots[name], SCENES[0],
                  "dumps", novel)
    return roots


def _replay_jax_draws(seed, hw, out_hw):
    """The augmentation parameters JAX's _host_augment draws from
    jax.random.key(seed), as the port's augment takes them."""
    return stack([jax_params(jax.random.key(seed), hw, out_hw)])


def _same_items(got, ref, img_tol=0.0, share=0.0, label_share=1.0):
    assert got.keys() == ref.keys()
    for k in ref:
        a, b = got[k], ref[k]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in ("img",) and (img_tol or share):
                d = np.abs(a - b)
                assert d.max() <= img_tol and (d > 0).mean() <= share, \
                    (k, d.max(), (d > 0).mean())
            elif k in ("label", "nerf_label") and label_share < 1:
                assert (a == b).mean() >= label_share, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert type(a) is type(b) and a == b, k


MODES = {
    # name: (ScanNetNGPJoint keyword arguments)
    "val": dict(mode="val", only_new_scene=False),
    "train_val": dict(mode="train_val", only_new_scene=False),
    "predict": dict(mode="predict"),
    "predict_novel": dict(mode="predict", use_novel_viewpoints=True),
    "train_new": dict(mode="train"),
    "train_replay": dict(mode="train", only_new_scene=False,
                         replay_buffer_size=2),
    "train_replay_novel": dict(mode="train", only_new_scene=False,
                               replay_buffer_size=3,
                               use_novel_viewpoints=True),
    "train_replay_no_augmentation": dict(mode="train", only_new_scene=False,
                                         replay_buffer_size=4,
                                         data_augmentation=False),
}


def _datasets(root, kw, exp_name="dumps", seed=3):
    """The JAX and the port's dataset on one root (the port's with JAX's
    augmentation draws replayed); the novel-viewpoint modes first write
    scene 0's interpolated poses through JAX's predict dataset."""
    kw = dict(kw)
    scenes = SCENES if kw.get("only_new_scene", True) is False else \
        SCENES[:1] if kw["mode"] == "predict" else SCENES
    if kw["mode"] in ("val", "train_val"):
        kw["val_scene_list"] = SCENES
    common = dict(root=root, scene_list=scenes, exp_name=exp_name,
                  output_size=(H, W), seed=seed, **kw)
    if kw.get("use_novel_viewpoints") and kw["mode"] == "train":
        jds.ScanNetNGPJoint(root=root, scene_list=SCENES[:1],
                            exp_name=exp_name, mode="predict",
                            use_novel_viewpoints=True, output_size=(H, W))
    ref = jds.ScanNetNGPJoint(**common)
    got = tds.ScanNetNGPJoint(**common, augment_params=_replay_jax_draws)
    return got, ref


@pytest.mark.parametrize("mode", list(MODES))
def test_scannet_ngp_joint_items_match_jax(fixture, mode):
    """Every item of every mode, field by field, with PNG colour frames
    (exact, but for augmented old-scene items: image within 1e-5, labels
    ≥ 0.999 equal), and the length; the novel-viewpoint modes also write
    the same interpolated_data.json."""
    root = fixture["port_png"]
    got, ref = _datasets(root, MODES[mode])
    assert len(got) == len(ref) > 0
    augmented = mode in ("train_replay", "train_replay_novel")
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        if augmented and b["from_old_scene"]:
            _same_items(a, b, img_tol=1e-5, share=1.0, label_share=0.999)
        else:
            _same_items(a, b)
    if mode == "predict_novel":
        # the port's dataset wrote the file last; JAX's writes it again
        path = os.path.join(root, SCENES[0], "dumps", "novel_viewpoints",
                            "interpolated_data.json")
        written = json.load(open(path))
        jds.ScanNetNGPJoint(root=root, scene_list=SCENES[:1],
                            exp_name="dumps", mode="predict",
                            use_novel_viewpoints=True, output_size=(H, W))
        assert json.load(open(path)) == written
    if mode == "train_replay":
        assert sum(ref[i]["from_old_scene"] for i in range(len(ref))) == 2


def test_scannet_ngp_joint_jpeg_items_match_jax(fixture):
    """JPEG colour (the JAX package's own fixture): the new-scene items
    within JPEG_TOL, every other field exact."""
    for kw in (MODES["train_new"], MODES["val"]):
        got, ref = _datasets(fixture["jax"], kw)
        for i in range(len(ref)):
            _same_items(got[i], ref[i], *JPEG_TOL)


def test_collate_matches_jax(fixture):
    """A batch of old and new items (with cl replay keys) split three ways
    exactly as JAX's collate splits it."""
    _, ref = _datasets(fixture["port_png"], MODES["train_replay"])
    rng = np.random.default_rng(2)
    items = [ref[i] for i in (0, 3, 1, 4)]
    for it in items:
        it["replay_img"] = rng.uniform(0, 1, (2, H, W, 3))
        it["replay_label"] = rng.integers(-1, 40, (2, H, W))
    out_t = tds.ScanNetNGPJoint.collate(copy.deepcopy(items))
    out_j = jds.ScanNetNGPJoint.collate(copy.deepcopy(items))
    assert all(b is not None for b in out_j)
    for a, b in zip(out_t, out_j):
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], list):
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert out_t[2]["replay_img"].shape == (4, 2, H, W, 3)


@pytest.mark.parametrize("novel", [False, True])
def test_port_predict_dumps_read_by_jax_as_jax_dumps(fixture, novel):
    """The same predict outputs dumped by the port's write_predict_outputs
    and by the JAX package's give JAX's dataset the same old-scene replay
    items (normal, and novel viewpoints through interpolated_data.json),
    and the same bytes of pixels."""
    root = fixture["port_png"]
    _dump(tloop.write_predict_outputs, root, SCENES[0], "port_dumps", novel)
    for name in tloop.PREDICT_SUBFOLDERS:
        sub = os.path.join("novel_viewpoints" if novel else "", name)
        for k in range(5):
            a = cv2.imread(os.path.join(root, SCENES[0], "port_dumps", sub,
                                        f"{k}.png"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(root, SCENES[0], "dumps", sub,
                                        f"{k}.png"), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(a, b)
    kw = MODES["train_replay_novel" if novel else "train_replay"]
    _, ref = _datasets(root, kw, "dumps")
    _, got = _datasets(root, kw, "port_dumps")
    n_old = 0
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        n_old += b["from_old_scene"]
        _same_items(a, b)
    assert n_old > 0


def test_port_writer_gives_jax_the_jax_writers_items(fixture):
    """The port's write_synthetic_scene_dir (JPEG colour, as JAX writes
    it): JAX's dataset reads the items JAX's own writer gives, the colour
    within JPEG_TOL, everything else exact; the transforms JSON equal."""
    for scene in SCENES:
        a = json.load(open(os.path.join(fixture["port_jpg"], scene,
                                        "transforms_train.json")))
        b = json.load(open(os.path.join(fixture["jax"], scene,
                                        "transforms_train.json")))
        assert a == b
    for kw in (MODES["train_new"], MODES["val"], MODES["predict"]):
        _, ref = _datasets(fixture["jax"], kw)
        _, got = _datasets(fixture["port_jpg"], kw)
        for i in range(len(ref)):
            _same_items(got[i], ref[i], *JPEG_TOL)
