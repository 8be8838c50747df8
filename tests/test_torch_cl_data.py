"""The port's continual-learning data layer against the JAX package's, on
the CPU: LabelLoaderAuto, rescale_to_canonical, the ScanNet-25k dataset,
the replay mixers, the synthetic 25k tree and the 25k test set.

Tolerances:
  * label decodes (FAST, MAPPED, RGBA), the format strings, get_probs,
    nearest rescales, replay draws: bit-equal;
  * images: within 1e-5 of JAX's (cv2's INTER_LINEAR; the augmentation's
    jitter and bilinear rotation, JAX's draws replayed through
    `augment_params`);
  * augmented labels: equal (the rotation's nearest taps of both sides
    agree on these frames);
  * eval_25k's three metrics: within 1e-6.
"""

import os
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_data import _replay_jax_draws
from ucsa_neural_rendering_tpu.data import augmentation as jaug
from ucsa_neural_rendering_tpu.data import cl_mixers as jmix
from ucsa_neural_rendering_tpu.data import label_loader as jll
from ucsa_neural_rendering_tpu.data import scannet as jsn
from ucsa_neural_rendering_tpu.data import scannet_ngp_joint as jds
from ucsa_neural_rendering_tpu.data import synthetic as jsyn
from ucsa_neural_rendering_tpu.train import seg_eval as jeval
from ucsa_neural_rendering_tpu_torch.data import augmentation as taug
from ucsa_neural_rendering_tpu_torch.data import cl_mixers as tmix
from ucsa_neural_rendering_tpu_torch.data import label_loader as tll
from ucsa_neural_rendering_tpu_torch.data import scannet as tsn
from ucsa_neural_rendering_tpu_torch.data import scannet_ngp_joint as tds
from ucsa_neural_rendering_tpu_torch.data import synthetic as tsyn
from ucsa_neural_rendering_tpu_torch.data.image_io import read_png
from ucsa_neural_rendering_tpu_torch.data.splits import save_split
from ucsa_neural_rendering_tpu_torch.train import seg_eval as teval

OUT = (24, 32)  # the datasets' output size; the 25k frames are 48×64
SCENES_25K, FRAMES_25K = 3, 4


# ------------------------------------------------------------ the labels
def _write_tsv(root, ids, nyu):
    pd.DataFrame({"id": ids, "nyu40id": nyu,
                  "raw_category": [f"r{i}" for i in ids]}).to_csv(
        os.path.join(root, "scannetv2-labels.combined.tsv"), sep="\t",
        index=False)


def _pack(cls, p1023):
    return (np.asarray(cls, np.uint16) << 10) | np.asarray(p1023, np.uint16)


def _rgba_labels(rng, h, w):
    """16-bit probability-packed RGBA labels with every decode case: random
    classes and probabilities, a tie between two classes (the lower wins),
    a class repeated in a later channel (it overwrites), classes ≥ 40 (0
    probability), and pixels under the confidence floors."""
    cls = rng.integers(0, 40, (h, w, 3))
    prob = rng.integers(0, 1024, (h, w, 3))
    cls[0, 0], prob[0, 0] = [10, 5, 30], [512, 512, 100]      # tie
    cls[0, 1], prob[0, 1] = [5, 7, 5], [920, 512, 102]        # duplicate
    cls[0, 2], prob[0, 2] = [45, 2, 63], [1023, 300, 1000]    # class ≥ 40
    cls[0, 3], prob[0, 3] = [39, 50, 3], [900, 1023, 1]       # ≥ 40 on 39
    prob[1, :] = rng.integers(0, 200, (w, 3))                 # low floor
    img = np.zeros((h, w, 4), np.uint16)
    img[..., :3] = _pack(cls, prob)
    img[..., 3] = 65535
    return img


@pytest.fixture(scope="module")
def label_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("labels"))
    # ids with gaps, mapped to classes out of order
    ids = [1, 2, 7, 100, 1163, 40]
    _write_tsv(root, ids, [5, 2, 40, 11, 39, 1])
    rng = np.random.default_rng(0)
    h, w = 9, 13
    files = {}
    files["fast"] = os.path.join(root, "fast.png")
    cv2.imwrite(files["fast"], rng.integers(0, 41, (h, w)).astype(np.uint8))
    files["mapped"] = os.path.join(root, "mapped.png")
    cv2.imwrite(files["mapped"], rng.choice([0] + ids, (h, w)).astype(
        np.uint16))
    rgba = _rgba_labels(rng, h, w)
    files["rgba"] = os.path.join(root, "rgba.png")
    cv2.imwrite(files["rgba"], rgba[..., [2, 1, 0, 3]])  # cv2 takes BGRA
    ok = rgba.copy()
    ok[..., :3] = _pack(np.minimum(ok[..., :3] >> 10, 39), ok[..., :3] & 1023)
    files["rgba_in_range"] = os.path.join(root, "rgba_in_range.png")
    cv2.imwrite(files["rgba_in_range"], ok[..., [2, 1, 0, 3]])
    return root, files


@pytest.mark.parametrize("confidence", [0, 0.3])
@pytest.mark.parametrize("kind", ["fast", "mapped", "rgba"])
def test_label_loader_matches_jax(label_files, kind, confidence):
    """get() of each format: the labels and the format string equal to
    JAX's, bit for bit (RGBA: its tie, duplicate and ≥ 40 pixels
    included)."""
    root, files = label_files
    got = tll.LabelLoaderAuto(root, confidence).get(files[kind])
    ref = jll.LabelLoaderAuto(root, confidence).get(files[kind])
    assert got[1] == ref[1] == {"fast": "FAST", "mapped": "MAPPED",
                                "rgba": "RGBA"}[kind]
    assert got[0].dtype == ref[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], ref[0])
    if kind == "rgba":
        assert got[0][0, 0] == 6 and got[0][0, 1] == 8  # tie, duplicate
        assert (got[0][1] == 0).any() == (confidence > 0)


def test_label_loader_probs_and_refusals(label_files, tmp_path):
    """get_probs equal to JAX's; a class ≥ 40 in get_probs, a paletted PNG,
    a 3-channel label and a raw id past the tsv raise, naming the file."""
    root, files = label_files
    loader = tll.LabelLoaderAuto(root)
    got = loader.get_probs(files["rgba_in_range"])
    ref = jll.LabelLoaderAuto(root).get_probs(files["rgba_in_range"])
    assert got.dtype == ref.dtype and got.shape == (9, 13, 40)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="rgba.png: class"):
        loader.get_probs(files["rgba"])
    from PIL import Image
    pal = str(tmp_path / "pal.png")
    Image.fromarray(np.zeros((4, 5), np.uint8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="pal.png: paletted"):
        loader.get(pal)
    rgb = str(tmp_path / "rgb.png")
    cv2.imwrite(rgb, np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError, match="rgb.png"):
        loader.get(rgb)
    far = str(tmp_path / "far.png")
    cv2.imwrite(far, np.full((4, 5), 5000, np.uint16))
    with pytest.raises(ValueError, match="far.png: raw id 5000"):
        loader.get(far)


# ------------------------------------------------------------ the rescale
@pytest.mark.parametrize("hw,out,expect", [
    ((48, 64), (240, 320), (288, 384)),     # grow
    ((968, 1296), (240, 320), (288, 385)),  # shrink: ScanNet-25k's frames
    ((300, 400), (240, 320), (300, 400)),   # in between: unchanged
])
def test_rescale_to_canonical_matches_jax(hw, out, expect):
    """The image within 1e-5 of JAX's cv2 INTER_LINEAR, the labels (two
    planes) equal to its INTER_NEAREST, the sizes equal; 968 · 0.2975 is
    288.0 in doubles and must not floor to 287."""
    rng = np.random.default_rng(sum(hw))
    img = rng.random((*hw, 3), dtype=np.float32)
    labels = [rng.integers(0, 41, hw).astype(np.float32) for _ in range(2)]
    got_img, got_labels = taug.rescale_to_canonical(img, labels, out)
    ref_img, ref_labels = jaug.rescale_to_canonical(img, labels, out)
    assert got_img.shape == ref_img.shape == (*expect, 3)
    assert got_img.dtype == ref_img.dtype
    np.testing.assert_allclose(got_img, ref_img, atol=1e-5, rtol=0)
    for a, b in zip(got_labels, ref_labels):
        assert a.shape == b.shape == expect and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- the 25k tree
@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The synthetic 25k tree written by each side (3 scenes × 4 frames of
    48×64, scene 1 noisy), with split files (every frame in train_cl and
    in test) in the port's; frame scene0002_00/3 has no labelled pixel."""
    base = tmp_path_factory.mktemp("trees")
    kw = dict(n_scenes=SCENES_25K, n_frames_per_scene=FRAMES_25K,
              variants=[0, 3, 5], frame_gain=0.1, pixel_noise=0.02)
    roots = {}
    for name, mod in (("jax", jsyn), ("port", tsyn)):
        roots[name] = str(base / name)
        os.makedirs(roots[name])
        mod.write_synthetic_25k_dir(roots[name], **kw)
        empty = os.path.join(roots[name], "scene0002_00", "label", "3.png")
        cv2.imwrite(empty, np.zeros((48, 64), np.uint8))
    paths = sorted(
        os.path.join(roots["port"], f"scene{s:04d}_00", "color", f"{k}.jpg")
        for s in range(SCENES_25K) for k in range(FRAMES_25K))
    roots["paths"] = paths
    save_split({"train": np.array(paths), "val": np.array(paths[:3]),
                "test": np.array(paths[:11]), "train_cl": np.array(paths)},
               os.path.join(roots["port"], "split.npz"))
    save_split({"train_cl": np.array(paths)},
               os.path.join(roots["port"], "split_cl.npz"))
    return roots


def test_synthetic_25k_tree_matches_jax(trees):
    """The same files: colour paths, the tsv's bytes, label PNG pixels, and
    JPEGs that decode (through the port's reader) to the same pixels."""
    from ucsa_neural_rendering_tpu_torch.data.image_io import read_rgb
    a, b = trees["port"], trees["jax"]
    files = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                             for d, _, fs in os.walk(r) for f in fs
                             if not f.endswith(".npz"))
    assert files(a) == files(b) and len(files(a)) == 1 + 2 * 12
    for rel in files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".tsv"):
            assert open(pa, "rb").read() == open(pb, "rb").read()
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(pa), read_png(pb))
        else:
            np.testing.assert_array_equal(read_rgb(pa), read_rgb(pb))


def _scannet_pair(root, paths, mode="train", seed=4, **kw):
    common = dict(root=root, img_list=paths, mode=mode, output_size=OUT,
                  seed=seed, **kw)
    return (tsn.ScanNet(**common, augment_params=_replay_jax_draws),
            jsn.ScanNet(**common))


def _same_item(got, ref):
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
            else:
                np.testing.assert_array_equal(a, b, err_msg=str(k))
        else:
            assert type(a) is type(b) and a == b, k


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_scannet_items_match_jax(trees, writer, mode):
    """Every item of both epochs after set_epoch, on each side's tree:
    train mode with JAX's draws replayed, test mode's centre crop. The
    unlabelled frame is redirected (resample-on-reject) to the frame JAX
    redirects to."""
    paths = [p.replace(trees["port"], trees[writer]) for p in trees["paths"]]
    got, ref = _scannet_pair(trees[writer], paths, mode)
    assert len(got) == len(ref) == 12
    for epoch in (0, 1):
        got.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert a[0].shape == (*OUT, 3) and a[1].shape == OUT
            _same_item(a, b)
        # the unlabelled frame's item is another frame's
        assert (got[11][1] != -1).sum() >= tsn.MIN_LABELLED


def _write_rgba_aux(paths, folder):
    rng = np.random.default_rng(1)
    out = []
    for k, p in enumerate(paths):
        name = os.path.join(folder, f"aux{k}.png")
        rgba = _rgba_labels(rng, 48, 64)
        rgba[..., :3] = _pack(np.minimum(rgba[..., :3] >> 10, 39),
                              rgba[..., :3] & 1023)
        cv2.imwrite(name, rgba[..., [2, 1, 0, 3]])
        out.append(name)
    return out


@pytest.mark.parametrize("fake", [False, True])
def test_scannet_aux_labels_match_jax(trees, tmp_path, fake):
    """Aux labels: RGBA files converted once to FAST `_c0.3_.png` siblings
    (each side converts its own copies: the same pixels), the items
    (img, label, aux, valid, img_ori) equal to JAX's with the aux plane
    under the main label's crop and flip; fake mode echoes the label with
    valid False."""
    paths = trees["paths"][:5]
    got, ref = _scannet_pair(trees["port"], paths, confidence_aux=0.3)
    if fake:
        got.set_aux_labels_fake(True)
        ref.set_aux_labels_fake(True)
    else:
        aux = {}
        for name in ("port", "jax"):
            os.makedirs(tmp_path / name)
            aux[name] = _write_rgba_aux(paths, str(tmp_path / name))
        got.enable_aux_labels(aux["port"])
        ref.enable_aux_labels(aux["jax"])
        assert [os.path.basename(p) for p in got.aux_label_pths] == \
            [os.path.basename(p) for p in ref.aux_label_pths] == \
            [f"aux{k}_c0.3_.png" for k in range(5)]
        for a, b in zip(got.aux_label_pths, ref.aux_label_pths):
            np.testing.assert_array_equal(read_png(a), cv2.imread(
                b, cv2.IMREAD_UNCHANGED))
        # converted once: a second enable keeps the converted files
        mtimes = [os.path.getmtime(p) for p in got.aux_label_pths]
        got.enable_aux_labels(got.aux_label_pths)
        assert [os.path.getmtime(p) for p in got.aux_label_pths] == mtimes
    for i in range(len(paths)):
        a, b = got[i], ref[i]
        assert len(a) == 5 and a[3] is (not fake)
        _same_item(a, b)


# ------------------------------------------------------------ the mixers
class _Frames:
    """A 25k stand-in that records the indices drawn from it."""

    def __init__(self, n):
        self.n, self.drawn = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.drawn.append(i)
        v = np.float32(i)
        return (np.full((2, 3, 3), v), np.full((2, 3), i, np.int32),
                np.full((2, 3, 3), -v))


class _Scene(_Frames):
    def __getitem__(self, i):
        return {"img": np.full((2, 3, 3), i, np.float32),
                "from_old_scene": False}


@pytest.mark.parametrize("ratio", [1, 3])
@pytest.mark.parametrize("mixer", ["ScanNetCLJoint", "ScanNetCL"])
def test_mixers_draw_jax_replay_indices(mixer, ratio):
    """From the same seed, over three epochs (set_epoch re-keys the draw)
    and items visited out of order: the same 25k indices as JAX's mixer,
    and set_epoch forwarded to both wrapped datasets."""
    drawn = {}
    for name, mod in (("port", tmix), ("jax", jmix)):
        frames, scene = _Frames(7), _Scene(5)
        epochs = []
        frames.set_epoch = epochs.append
        mix = getattr(mod, mixer)(frames, scene, ngp_25k_ratio=ratio, seed=9)
        for epoch in (0, 1, 2):
            mix.set_epoch(epoch)
            for i in (3, 0, 4, 4, 1):
                mix[i]
        drawn[name] = (frames.drawn, epochs)
    assert drawn["port"] == drawn["jax"]
    assert len(drawn["port"][0]) == 3 * 5 * ratio
    assert drawn["port"][1] == [0, 1, 2]


def test_mixer_items_and_collates_match_jax(trees, tmp_path):
    """Over real datasets: ScanNetCLJoint on a one-scene ScanNetNGPJoint
    (train mode) and the 25k ScanNet, ScanNetCL on two 25k ScanNets; both
    epochs' items and their collates (the joint mixer's three-way one, the
    finetune mixer's flat one) equal to JAX's, the replay frames'
    images within 1e-5."""
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_scene_dir
    scans = str(tmp_path / "scans")
    write_synthetic_scene_dir(scans, "scene0000_00", n_frames=5, H=OUT[0],
                              W=OUT[1], color_ext=".png")
    paths = trees["paths"]
    mixers = {}
    for name, ds_mod, mix_mod in (("port", tds, tmix), ("jax", jds, jmix)):
        s25k = _scannet_pair(trees["port"], paths, seed=2)[
            name == "jax"]
        scene = ds_mod.ScanNetNGPJoint(root=scans,
                                       scene_list=["scene0000_00"],
                                       mode="train", only_new_scene=False,
                                       output_size=OUT, seed=2)
        flat_scene = _scannet_pair(trees["port"], paths[:4], mode="test")[
            name == "jax"]
        mixers[name] = (mix_mod.ScanNetCLJoint(s25k, scene, 2, seed=2),
                        mix_mod.ScanNetCL(s25k, flat_scene, 2, seed=2))
    for epoch in (0, 1):
        for k in (0, 1):
            got, ref = mixers["port"][k], mixers["jax"][k]
            got.set_epoch(epoch)
            ref.set_epoch(epoch)
            a = [got[i] for i in range(len(got))]
            b = [ref[i] for i in range(len(ref))]
            if k == 0:
                for x, y in zip(a, b):
                    assert x.keys() == y.keys()
                    assert x["replay_img"].shape == (2, *OUT, 3)
                    np.testing.assert_allclose(x.pop("replay_img"),
                                               y.pop("replay_img"),
                                               atol=1e-5, rtol=0)
                    np.testing.assert_array_equal(x.pop("replay_label"),
                                                  y.pop("replay_label"))
                # the collate of the joint mixer: its scene's three-way
                batch = [got[i] for i in (0, 1)]
                jbatch = [ref[i] for i in (0, 1)]
                old, new, cl = got.collate(batch)
                jold, jnew, jcl = ref.collate(jbatch)
                assert old is None and jold is None
                assert cl.keys() == jcl.keys() == {"replay_img",
                                                   "replay_label"}
                assert cl["replay_img"].shape == (2, 2, *OUT, 3)
                np.testing.assert_allclose(cl["replay_img"],
                                           jcl["replay_img"], atol=1e-5,
                                           rtol=0)
                np.testing.assert_array_equal(cl["replay_label"],
                                              jcl["replay_label"])
                assert new.keys() == jnew.keys()
                for key in ("img", "label", "pose", "depth"):
                    np.testing.assert_array_equal(new[key], jnew[key])
            else:
                for x, y in zip(a, b):
                    _same_item(x[0], y[0])
                    assert len(x[1]) == len(y[1]) == 2
                    for u, v in zip(x[1], y[1]):
                        _same_item(u, v)
                got_c = got.collate(a)
                ref_c = ref.collate(b)
                assert len(got_c) == len(ref_c) == 3
                for u, v in zip(got_c, ref_c):
                    assert u.shape == v.shape and u.shape[0] == 4 * 3
                    _same_item((u,), (v,))


# ------------------------------------------------------- the 25k test set
def _infer_t(images):
    x = torch.as_tensor(images)
    return ((x[..., 0] * 50.0 + x[..., 1] * 30.0).floor().long() % 40)


def _infer_j(images):
    x = jnp.asarray(images)
    return jnp.floor(x[..., 0] * 50.0 + x[..., 1] * 30.0).astype(
        jnp.int32) % 40


def test_eval_25k_matches_jax(trees):
    """11 frames (a partial batch of 3 real frames and 5 pads): the three
    metrics within 1e-6 of JAX's, with the same deterministic labelling of
    the images on both sides; the pads never reach the meter."""
    got_ds, ref_ds = _scannet_pair(trees["port"], trees["paths"][:11],
                                   mode="test")
    got = teval.eval_25k(_infer_t, got_ds, 40)
    ref = jeval.eval_25k(_infer_j, ref_ds, 40)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert all(0.0 <= v <= 1.0 for v in got) and got[1] > 0
    view = teval._PaddedView(got_ds, 16)
    img, label = view[15]
    assert not img.any() and (label == -1).all() and view[12] is view[15]


def test_build_test_25k(trees, tmp_path):
    """None without a configured split file, with the file absent and with
    an empty test list; otherwise a test-mode ScanNet over the test list,
    its items equal to JAX's."""
    exp = {"data_module": {"data_preprocessing": {}}}
    env = {"scannet_frames_25k": trees["port"]}
    assert teval.build_test_25k(exp, env, OUT) is None
    exp["data_module"]["data_preprocessing"]["split_file"] = "absent.npz"
    assert teval.build_test_25k(exp, env, OUT) is None
    empty = str(tmp_path / "f25k")
    os.makedirs(empty)
    shutil.copy(os.path.join(trees["port"],
                             "scannetv2-labels.combined.tsv"), empty)
    save_split({"test": np.array([]), "train_cl": np.array([])},
               os.path.join(empty, "empty.npz"))
    exp["data_module"]["data_preprocessing"]["split_file"] = "empty.npz"
    assert teval.build_test_25k(exp, {"scannet_frames_25k": empty},
                                OUT) is None
    exp["data_module"]["data_preprocessing"]["split_file"] = "split.npz"
    got = teval.build_test_25k(exp, env, OUT)
    ref = jeval.build_test_25k(exp, env, OUT)
    assert isinstance(got, tsn.ScanNet) and got._mode == "test"
    assert got.image_pths == ref.image_pths == trees["paths"][:11]
    for i in (0, 10):
        _same_item(got[i], ref[i])
