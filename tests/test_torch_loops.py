"""The port's pretrain and finetune loops, their data layer (ScanNetNGP)
and their CLIs against the JAX package's, on the CPU.

Both sides start from one set of weights: a JAX tree drawn with numpy at
the tiny DeepLabV3's shapes (test_torch_seg.jax_weights, TINY_LAYOUT,
narrow widths, 6 classes), carried to the port by deeplab_state_from_jax;
the JAX SegTrainer.init is patched to return it. Dropout is pinned off on
both sides (the JAX model applies with deterministic=True, the port's
dropout runs at rate 0), and the port's datasets replay the JAX package's
augmentation draws (`augment_params`). The JAX pretrain loop runs on its
one-device path (jax.device_count patched to 1): the port has no mesh.

Data: a ScanNet-25k tree of 2 × 4 frames of 48×64 (6 train frames, so
that the pretrain's second batch of 2 is padded to 4; 2 val / test), and
a scene of 5 frames of 24×32 (4 train, 1 val) with predict dumps of every
frame under `one_step_nerf_only`, written twice: by the JAX package's
writers and by the port's.

Tolerances:
  * ScanNetNGP items: as tests/test_torch_data.py's ScanNetNGPJoint
    checks: JPEG colour within JPEG_TOL (1 level on ≤ 1 % of the
    samples), augmented images within 1e-5 and labels equal on ≥ 0.999
    of the pixels (rotation near-ties), everything else exact;
  * pretrain and finetune: the learning rate of each epoch equal; the
    epoch's mean train/loss within LOSS_RTOL = 1e-4 relative (the same
    inputs and weights; measured ≤ 2.3e-5 over the finetune's 4 Adam
    steps, ≤ 3.7e-6 over the pretrain's); evaluations
    before any training (finetune val_pre, test/25k_*_pre) within 1e-6;
    best_ckpt written at the same epochs;
  * the resume: bit for bit.
"""

import argparse
import contextlib
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _yaml, seg_dtypes
from test_torch_data import JPEG_TOL, _replay_jax_draws
from test_torch_joint_loop import _assert_same_bits
from test_torch_joint_trainer import SEG_KW, _NoDropout
from test_torch_opt_in import BF16_SEEN
from test_torch_seg import jax_weights, pin_dropout_off
from ucsa_neural_rendering_tpu.data import scannet_ngp as jngp
from ucsa_neural_rendering_tpu.data import synthetic as jsyn
from ucsa_neural_rendering_tpu.train import finetune_loop as jfinetune
from ucsa_neural_rendering_tpu.train import joint_loop as jloop
from ucsa_neural_rendering_tpu.train import pretrain_loop as jpretrain
from ucsa_neural_rendering_tpu.train import seg_trainer as jst
from ucsa_neural_rendering_tpu_torch.data import ScanNet, ScanNetNGP
from ucsa_neural_rendering_tpu_torch.data import synthetic as tsyn
from ucsa_neural_rendering_tpu_torch.data.splits import (create_split,
                                                         save_split)
from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3,
                                                    deeplab_state_from_jax)
from ucsa_neural_rendering_tpu_torch.scripts import pretrain as pretrain_cli
from ucsa_neural_rendering_tpu_torch.scripts import \
    train_finetune as finetune_cli
from ucsa_neural_rendering_tpu_torch.train import (JointTrainer, SegTrainer,
                                                   cl_driver)
from ucsa_neural_rendering_tpu_torch.train import finetune_loop as tfinetune
from ucsa_neural_rendering_tpu_torch.train import joint_loop as tloop
from ucsa_neural_rendering_tpu_torch.train import pretrain_loop as tpretrain
from ucsa_neural_rendering_tpu_torch.train.checkpoints import (load_deeplab,
                                                               load_tree,
                                                               save_tree)

H, W = 24, 32
C = SEG_KW["num_classes"]
SCENE = "scene0000_00"
PREV = "one_step_nerf_only"
LOSS_RTOL = 1e-4
EVAL_ATOL = 1e-6


# ------------------------------------------------------------------- data
def _dump_renders(write, root):
    """Predict dumps of every frame of SCENE under PREV, from seeded fake
    renders with labels in the model's C classes."""
    folder = os.path.join(root, SCENE, PREV)
    (tloop.make_predict_dirs if write is tloop.write_predict_outputs
     else jloop.make_predict_dirs)(folder)
    n = len(json.load(open(os.path.join(root, SCENE,
                                        "transforms_train.json")))["frames"])
    for k in range(n):
        rng = np.random.default_rng(k)
        write(folder, {"viewpoint_is_novel": False, "current_index": str(k)},
              {"nerf_rgb": rng.uniform(-0.1, 1.1, (H, W, 3)).astype(
                  np.float32),
               "nerf_semantics": rng.integers(0, C, (H, W)),
               "seg_semantics": rng.integers(0, C, (H, W))})


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The environment (results, scans, 25k tree with its split files);
    the scene under scans/ written by the port, under scans_jax/ by JAX."""
    root = tmp_path_factory.mktemp("loops")
    env = {"results": str(root / "results"), "scannet": str(root / "scans"),
           "scannet_jax": str(root / "scans_jax"),
           "scannet_frames_25k": str(root / "frames25k")}
    tsyn.write_synthetic_scene_dir(env["scannet"], SCENE, n_frames=5, H=H,
                                   W=W)
    _dump_renders(tloop.write_predict_outputs, env["scannet"])
    jsyn.write_synthetic_scene_dir(env["scannet_jax"], SCENE, n_frames=5,
                                   H=H, W=W)
    _dump_renders(jloop.write_predict_outputs, env["scannet_jax"])
    f25k = env["scannet_frames_25k"]
    tsyn.write_synthetic_25k_dir(f25k, n_scenes=2, n_frames_per_scene=4,
                                 H=2 * H, W=2 * W)
    split = create_split(f25k, "/*/color/*.jpg", 0.25, seed=0)
    save_split(split, os.path.join(f25k, "split.npz"))
    save_split({"train_cl": split["train_cl"]},
               os.path.join(f25k, "split_cl.npz"))
    return env


@pytest.mark.parametrize("n", [4, 3, 1])
def test_pad_to_matches_jax(n):
    """Wraparound copies of the real images, −1 labels, n_real."""
    rng = np.random.default_rng(n)
    img = rng.uniform(size=(n, 3, 2, 3)).astype(np.float32)
    label = rng.integers(-1, 5, (n, 3, 2)).astype(np.int32)
    got = tpretrain._pad_to((img, label), 4)
    ref = jpretrain._pad_to((img, label), 4)
    assert got[2] == ref[2] == n
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# name: ScanNetNGP keyword arguments
NGP_MODES = {
    **{f"train_{img}_{lab}": dict(mode="train", train_image=img,
                                  train_label=lab)
       for img in ("gt", "nerf", "half") for lab in ("nerf", "gt")},
    **{f"val_{m}": dict(mode="val", val_mode=m)
       for m in ("gtgt", "nerfgt", "nerfnerf")},
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", list(NGP_MODES))
def test_scannet_ngp_items_match_jax(env, writer, mode):
    """Every item of two passes (the second pass continues the dataset's
    one stream) against the JAX dataset's on the same tree: the scene
    written and its renders dumped by the JAX package's writers or by the
    port's. "half" draws the same coins: each item's image is the one of
    the source JAX chose (the fake renders differ from the frames)."""
    root = env["scannet_jax" if writer == "jax" else "scannet"]
    kw = dict(root=root, scene_list=[SCENE], prev_exp_name=PREV,
              output_size=(H, W), seed=5, **NGP_MODES[mode])
    ref = jngp.ScanNetNGP(**kw)
    got = ScanNetNGP(**kw, augment_params=_replay_jax_draws)
    assert len(got) == len(ref) == (4 if kw["mode"] == "train" else 1)
    augmented = kw["mode"] == "train"
    for i in list(range(len(ref))) * 2:
        a, b = got[i], ref[i]
        assert len(a) == len(b) == (3 if augmented else 4)
        if not augmented:
            assert a[3] == b[3] == SCENE
        for x, y in zip(a[:3], b[:3]):
            assert x.dtype == y.dtype and x.shape == y.shape
        d = np.abs(a[0] - b[0])
        jpeg = kw.get("train_image", "gt") != "nerf" and \
            kw.get("val_mode", "gtgt") == "gtgt"
        if augmented:
            assert d.max() <= 1e-5 + (JPEG_TOL[0] if jpeg else 0.0), d.max()
            assert (a[1] == b[1]).mean() >= 0.999
        else:
            assert d.max() <= (JPEG_TOL[0] if jpeg else 0.0)
            assert (d > 0).mean() <= JPEG_TOL[1]
            np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], a[2])
        assert a[1].min() >= -1 and a[1].max() < C


# ---------------------------------------------------------------- the loops
@pytest.fixture(scope="module")
def weights():
    """The shared start, its classifier 30× wider and unbiased, so that a
    fresh net's labels vary over the pixels and some of them are right."""
    params, stats = jax_weights(_NoDropout(**SEG_KW), (1, H, W, 3), seed=4)
    params["classifier"]["kernel"] = params["classifier"]["kernel"] * 30.0
    params["classifier"]["bias"] = np.zeros_like(params["classifier"]["bias"])
    return params, stats


def _port_model(weights, dropout=False, compute_dtype=None):
    model = DeepLabV3(**SEG_KW, device="cpu", compute_dtype=compute_dtype)
    model.load_state_dict(deeplab_state_from_jax(*weights))
    if not dropout:
        pin_dropout_off(model)
    return model


def _start_jax_from(weights, monkeypatch):
    params, stats = weights
    monkeypatch.setattr(
        jst.SegTrainer, "init",
        lambda self, key, image_hw=None: (params, stats,
                                          self.tx.init(params)))


def _records(env, name):
    with open(os.path.join(env["results"], name, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _series(records, key):
    return [r[key] for r in records if key in r]


def _names(records):
    return {k for r in records for k in r} - {"step", "time"}


def _pretrain_exp(env, name, max_epochs=2, resume=False, clean=True):
    return {
        "general": {"name": name, "clean_up_folder_if_exists": clean},
        "model": {"num_classes": C},
        "lr_scheduler": {"active": True, "name": "POLY",
                         "poly_cfg": {"power": 0.9, "max_epochs": 3,
                                      "target_lr": 1e-6}},
        "optimizer": {"lr": 1e-3, "name": "Adam"},
        "trainer": {"max_epochs": max_epochs,
                    "resume_from_checkpoint": resume},
        "data_module": {"batch_size": 4, "shuffle": True, "drop_last": False,
                        "root": env["scannet_frames_25k"],
                        "data_preprocessing": {"split_file": "split.npz"}},
        "output_size": (H, W),
    }


def _args(**kw):
    return argparse.Namespace(seed=0, project_name="t", device="cpu", **kw)


def _best_epochs(val_mious):
    best, out = -1.0, []
    for e, m in enumerate(val_mious):
        if m > best:
            best = m
            out.append(e)
    return out


def test_pretrain_matches_jax(env, weights, monkeypatch):
    """Two epochs (6 frames, batches of 4 and a padded 2) from one set of
    weights: the same metric names, the POLY lr of each epoch equal, the
    epoch's train/loss within LOSS_RTOL, best_ckpt written at the same
    epochs (the port's save calls counted), test/* finite."""
    _start_jax_from(weights, monkeypatch)
    monkeypatch.setattr(jpretrain.jax, "device_count", lambda: 1)
    monkeypatch.setattr(tpretrain, "ScanNet", functools.partial(
        ScanNet, augment_params=_replay_jax_draws))
    saves = []
    real_save = tpretrain.save_deeplab
    monkeypatch.setattr(tpretrain, "save_deeplab",
                        lambda *a: (saves.append(a[0]), real_save(*a)))
    jpretrain.train(_pretrain_exp(env, "pre_jax"), env, _args(),
                    model=_NoDropout(**SEG_KW))
    trainer, best = tpretrain.train(_pretrain_exp(env, "pre_port"), env,
                                    _args(), model=_port_model(weights))
    ref, got = _records(env, "pre_jax"), _records(env, "pre_port")
    assert _names(got) == _names(ref)
    assert _series(got, "lr") == _series(ref, "lr")
    assert _series(got, "lr")[1] < _series(got, "lr")[0]
    np.testing.assert_allclose(_series(got, "train/loss"),
                               _series(ref, "train/loss"), rtol=LOSS_RTOL)
    val_got = _series(got, "val/mean_IoU")
    assert _best_epochs(val_got) == _best_epochs(_series(ref,
                                                         "val/mean_IoU"))
    assert len(saves) == len(_best_epochs(val_got))
    assert best == max(val_got)
    for k in ("test/mean_IoU", "test/total_accuracy", "test/mean_accuracy"):
        assert np.isfinite(_series(got, k)).all()
    # best_ckpt holds the model of the best epoch, last_ckpt the end state
    run = os.path.join(env["results"], "pre_port")
    last = load_tree(os.path.join(run, "last_ckpt"))
    assert last["epoch"] == 2 and last["best_miou"] == best
    _assert_same_bits(last["model"], trainer.model.state_dict())


@pytest.mark.parametrize("best_in_ckpt", ["kept", "high", "missing"])
def test_pretrain_resume_bit_for_bit(env, weights, best_in_ckpt):
    """Dropout on, from its per-step generators. A run killed after epoch 1
    (max_epochs 1) and resumed to 2 equals the uninterrupted 2-epoch run
    bit for bit: model and optimizer, in memory and in last_ckpt. The best
    score resumes from last_ckpt: as written ("kept"), an unbeatable 0.99
    that epoch 2 must not displace ("high"), or, from a last_ckpt written
    without it, at −1, so that epoch 2's score becomes the best
    ("missing")."""
    whole, _ = tpretrain.train(_pretrain_exp(env, "whole"), env, _args(),
                               model=_port_model(weights, dropout=True))
    name = f"cut_{best_in_ckpt}"
    tpretrain.train(_pretrain_exp(env, name, max_epochs=1), env, _args(),
                    model=_port_model(weights, dropout=True))
    last = os.path.join(env["results"], name, "last_ckpt")
    tree = load_tree(last)
    assert tree["epoch"] == 1
    if best_in_ckpt == "high":
        tree["best_miou"] = 0.99
    elif best_in_ckpt == "missing":
        del tree["best_miou"]
    save_tree(last, tree)
    resumed, best = tpretrain.train(
        _pretrain_exp(env, name, resume=True, clean=False), env, _args(),
        model=_port_model(weights, dropout=True))
    for tr in (whole, resumed):
        assert tr.model.classifier[0].dropout.p > 0
    _assert_same_bits(resumed.model.state_dict(), whole.model.state_dict())
    _assert_same_bits(resumed.optimizer.state_dict(),
                      whole.optimizer.state_dict())
    ref = _records(env, "whole")
    got = _records(env, name)
    assert _series(got, "train/loss")[-1] == _series(ref, "train/loss")[-1]
    vals = _series(ref, "val/mean_IoU")
    expected = {"kept": max(vals), "high": 0.99, "missing": vals[1]}
    assert best == expected[best_in_ckpt]
    assert load_tree(last)["best_miou"] == best


def _finetune_exp(name, cl, max_epochs=2):
    return {
        "general": {"name": name, "clean_up_folder_if_exists": True,
                    "checkpoint_load": None},
        "model": {"num_classes": C},
        "lr_scheduler": {"active": False},
        "optimizer": {"lr": 1e-3, "name": "Adam"},
        "trainer": {"max_epochs": max_epochs,
                    "resume_from_checkpoint": False,
                    "load_from_checkpoint": False},
        "data_module": {"batch_size": 2, "train_image": "nerf",
                        "train_label": "nerf",
                        "data_preprocessing": {
                            "split_file": "split.npz",
                            "split_file_cl": "split_cl.npz"}},
        "scenes": [SCENE],
        "cl": {"active": cl, "25k_fraction": 1.0, "ngp_25k_ratio": 1,
               "use_novel_viewpoints": False, "replay_buffer_size": 0},
        "output_size": (H, W),
    }


@pytest.mark.parametrize("cl", [False, True])
def test_finetune_matches_jax(env, weights, monkeypatch, cl):
    """Two epochs on the port's renders (with 25k replay under cl) from one
    set of weights: the same metric names, val_pre and test/25k_*_pre
    within EVAL_ATOL (eval mode, the same inputs), the epoch's train/loss
    within LOSS_RTOL, val and test/25k_*_post finite; deeplab_ckpt holds
    the trainer's model and loads as checkpoint_load in the port's joint
    loop."""
    _start_jax_from(weights, monkeypatch)
    for mod in ("ScanNet", "ScanNetNGP"):
        monkeypatch.setattr(tfinetune, mod, functools.partial(
            getattr(tfinetune, mod), augment_params=_replay_jax_draws))
    name = f"fine_{'cl' if cl else 'plain'}"
    jfinetune.train(_finetune_exp(name + "_jax", cl), env, _args(),
                    model=_NoDropout(**SEG_KW), prev_exp_name=PREV)
    trainer = tfinetune.train(_finetune_exp(name + "_port", cl), env,
                              _args(), model=_port_model(weights),
                              prev_exp_name=PREV)
    ref, got = _records(env, name + "_jax"), _records(env, name + "_port")
    assert _names(got) == _names(ref)
    pre = sorted(k for k in _names(ref)
                 if k.startswith("val_pre/") or k.endswith("_pre"))
    assert len(pre) == 5
    assert max(_series(ref, "test/25k_total_accuracy_pre")) > 0
    for k in pre:
        np.testing.assert_allclose(_series(got, k), _series(ref, k),
                                   rtol=0, atol=EVAL_ATOL, err_msg=k)
    np.testing.assert_allclose(_series(got, "train/loss"),
                               _series(ref, "train/loss"), rtol=LOSS_RTOL)
    assert len(_series(got, "train/loss")) == 2
    for k in _names(got):
        assert np.isfinite(_series(got, k)).all(), k
    ckpt = os.path.join(env["results"], name + "_port", "deeplab_ckpt")
    _assert_same_bits(load_deeplab(ckpt), trainer.model.state_dict())
    _assert_same_bits(_joint_loop_start(env, ckpt, "train_joint"),
                      trainer.model.state_dict())


@pytest.mark.parametrize("loop", ["pretrain", "finetune"])
def test_loops_match_jax_at_seg_bf16(env, weights, monkeypatch, loop):
    """model.compute_dtype: bfloat16. One epoch of each loop from one set
    of weights, the port's default net built by the loop (the tiny one
    patched in) with the compute dtype the loop passes, JAX's at dtype
    bfloat16: the same metric names, every value finite, the parameters
    f32, the net's convolutions and BNs writing bf16 and its logits f32
    (chip_smoke.seg_dtypes), and the epoch's train/loss within 3e-2
    relative. The shared start's 30× classifier puts the logits near ±30,
    where a bf16 ulp is 0.125, and on the CPU XLA keeps f32 between the
    ops of a bf16 fusion where torch rounds each op: JAX's own bf16 epoch
    lies 2.0 % (pretrain) and 2.9 % (finetune) from its f32 one, the
    port's 2.1 % and 2.5 % from JAX's bf16 one."""
    _start_jax_from(weights, monkeypatch)
    jmodel = _NoDropout(**SEG_KW, dtype=jnp.bfloat16)
    name = f"{loop}_bf16"
    if loop == "pretrain":
        monkeypatch.setattr(jpretrain.jax, "device_count", lambda: 1)
        monkeypatch.setattr(tpretrain, "ScanNet", functools.partial(
            ScanNet, augment_params=_replay_jax_draws))
        exps = [_pretrain_exp(env, name + side, max_epochs=1)
                for side in ("_jax", "_port")]
    else:
        for mod in ("ScanNet", "ScanNetNGP"):
            monkeypatch.setattr(tfinetune, mod, functools.partial(
                getattr(tfinetune, mod), augment_params=_replay_jax_draws))
        exps = [_finetune_exp(name + side, False, max_epochs=1)
                for side in ("_jax", "_port")]
    for exp in exps:
        exp["model"]["compute_dtype"] = "bfloat16"
    tmod = tpretrain if loop == "pretrain" else tfinetune
    seen = []
    with contextlib.ExitStack() as hooks:

        def build(num_classes, device, generator, compute_dtype):
            model = _port_model(weights, compute_dtype=compute_dtype)
            seen.append(hooks.enter_context(seg_dtypes(model)))
            return model

        monkeypatch.setattr(tmod, "DeepLabV3", build)
        if loop == "pretrain":
            jpretrain.train(exps[0], env, _args(), model=jmodel)
            trainer, _ = tpretrain.train(exps[1], env, _args())
        else:
            jfinetune.train(exps[0], env, _args(), model=jmodel,
                            prev_exp_name=PREV)
            trainer = tfinetune.train(exps[1], env, _args(),
                                      prev_exp_name=PREV)
    assert trainer.model.compute_dtype == torch.bfloat16
    assert seen == [BF16_SEEN], seen
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    ref, got = _records(env, name + "_jax"), _records(env, name + "_port")
    assert _names(got) == _names(ref)
    for k in _names(got):
        assert np.isfinite(_series(got, k)).all(), k
    np.testing.assert_allclose(_series(got, "train/loss"),
                               _series(ref, "train/loss"), rtol=3e-2)


# ----------------------------------------------- checkpoint interchange
class _Loaded(Exception):
    """Raised once a consumer has loaded its checkpoint."""


def _weights_of(state):
    return {k: v.clone() for k, v in state.items()}


def _stop_after(monkeypatch, cls):
    """cls.init runs, then the seg model's state is raised in _Loaded."""
    real = cls.init

    def init(self, *a, **kw):
        real(self, *a, **kw)
        model = self.seg.model if cls is JointTrainer else self.model
        raise _Loaded(_weights_of(model.state_dict()))
    monkeypatch.setattr(cls, "init", init)


def _joint_loop_start(env, ckpt, consumer, monkeypatch=None):
    """The seg weights a consumer starts from with `ckpt` as its
    general.checkpoint_load: the port's train_joint stage, cl_deeplab's
    stage 0 or the finetune, each stopped right after its load."""
    mp = monkeypatch or pytest.MonkeyPatch()
    try:
        exp = {"general": {"name": f"load_{consumer}",
                           "clean_up_folder_if_exists": True,
                           "checkpoint_load": ckpt},
               "model": {"num_classes": C},
               "optimizer": {"lr_seg": 1e-5, "lr_nerf": 1e-2, "lr": 1e-5,
                             "name": "Adam"},
               "trainer": {"load_from_checkpoint": True, "max_epochs": 1,
                           "resume_from_checkpoint": False},
               "data_module": {"batch_size": 2},
               "scenes": [SCENE], "cl": {"active": False},
               "output_size": (H, W)}
        seg = DeepLabV3(**SEG_KW, device="cpu",
                        generator=torch.Generator().manual_seed(9))
        if consumer == "finetune":
            _stop_after(mp, SegTrainer)
            call = lambda: tfinetune.train(exp, env, _args(), model=seg,
                                           prev_exp_name=PREV)
        else:
            from test_torch_joint_trainer import MODEL_KW
            from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
            _stop_after(mp, JointTrainer)
            kw = {"nerf_model": SemanticNeRF(**MODEL_KW, device="cpu"),
                  "seg_model": seg}
            args = _args(exp_name="load", fix_nerf=False,
                         nerf_train_epoch=0, joint_train_epoch=0)
            if consumer == "train_joint":
                call = lambda: tloop.train(exp, env, args,
                                           trainer_kwargs=kw)
            else:
                call = lambda: cl_driver.main(exp, env, args,
                                              scene_order=[SCENE],
                                              trainer_kwargs=kw)
        with pytest.raises(_Loaded) as stop:
            call()
        return stop.value.args[0]
    finally:
        if monkeypatch is None:
            mp.undo()


@pytest.mark.parametrize("consumer", ["train_joint", "cl_deeplab",
                                      "finetune"])
def test_pretrain_best_ckpt_loads_as_checkpoint_load(env, weights,
                                                     consumer, monkeypatch):
    """The pretrain's best_ckpt is a general.checkpoint_load for the joint
    stage, the protocol's stage 0 and the finetune: each starts from its
    weights bit for bit."""
    ckpt = os.path.join(env["results"], "pretrain_src", "best_ckpt")
    if not os.path.isdir(ckpt):
        tpretrain.train(_pretrain_exp(env, "pretrain_src", max_epochs=1),
                        env, _args(), model=_port_model(weights))
    _assert_same_bits(_joint_loop_start(env, ckpt, consumer, monkeypatch),
                      load_deeplab(ckpt))


# ------------------------------------------------------------------ CLIs
def _dump_yaml(tree, path):
    with open(path, "w") as f:
        f.write("\n".join(_yaml(tree)) + "\n")


def _write_env(tmp_path, env, monkeypatch):
    with open(tmp_path / "env.yml", "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in env.items()))
    monkeypatch.setenv("ENV_WORKSTATION_NAME", str(tmp_path / "env"))


def test_clis_run_on_the_cpu(env, weights, tmp_path, monkeypatch, capsys):
    """With --device cpu both CLIs run their loop from a YAML experiment
    (the tiny seg net patched in as their default model): the pretrain
    writes best_ckpt, and the finetune starts from it and writes
    deeplab_ckpt; --help names TF32."""
    _write_env(tmp_path, {k: env[k] for k in ("results", "scannet",
                                              "scannet_frames_25k")},
               monkeypatch)
    monkeypatch.setattr(
        tpretrain, "DeepLabV3",
        lambda num_classes, device, generator, compute_dtype: _port_model(
            weights, compute_dtype=compute_dtype))
    monkeypatch.setattr(
        tfinetune, "DeepLabV3",
        lambda num_classes, device, generator, compute_dtype: _port_model(
            weights, compute_dtype=compute_dtype))
    from ucsa_neural_rendering_tpu_torch.config import load_yaml
    exp = _pretrain_exp(env, "cli_pre", max_epochs=1)
    exp["output_size"] = list(exp["output_size"])
    exp_path = str(tmp_path / "pre.yml")
    _dump_yaml(exp, exp_path)
    assert load_yaml(exp_path) == exp
    trainer, best = pretrain_cli.main(["--exp", exp_path, "--seed", "0",
                                       "--device", "cpu"])
    best_ckpt = os.path.join(env["results"], "cli_pre", "best_ckpt")
    assert os.path.isdir(best_ckpt) and np.isfinite(best)
    fexp = _finetune_exp("cli_fine", cl=False, max_epochs=1)
    fexp["general"]["checkpoint_load"] = best_ckpt
    fexp["trainer"]["load_from_checkpoint"] = True
    fexp["output_size"] = list(fexp["output_size"])
    fexp_path = str(tmp_path / "fine.yml")
    _dump_yaml(fexp, fexp_path)
    out = finetune_cli.main(["--exp", fexp_path, "--seed", "0",
                             "--prev_exp_name", PREV, "--device", "cpu"])
    assert isinstance(out, SegTrainer)
    assert os.path.isdir(os.path.join(env["results"], "cli_fine",
                                      "deeplab_ckpt"))
    for cli in (pretrain_cli, finetune_cli):
        with pytest.raises(SystemExit):
            cli.main(["--help"])
        assert "TF32" in " ".join(capsys.readouterr().out.split())
