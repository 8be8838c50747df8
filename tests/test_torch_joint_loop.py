"""The port's joint loop (one adaptation stage) against the JAX package's,
on the CPU.

Both sides start from one set of weights, as in
tests/test_torch_joint_trainer.py (its `setup`: a tiny Semantic-NeRF of
bound 1 and 6 classes with decisive semantic logits, DeepLabV3 at
TINY_LAYOUT and narrow widths, an all-ones 16³ grid), on the synthetic
room (scene0000_00, 5 frames at 24×32, PNG colour) written by the port's
writer. The JAX side runs its loop functions; no whole JAX stage runs.

Tolerances:
  * test_nerf: the rendered labels equal on ≥ 0.99 of the pixels wherever
    they are not near-ties (tests/test_torch_joint_trainer._check_labels);
    its three metrics within 0.02 (a flipped pixel moves a class's IoU);
  * validate_seg: eval-mode labels of identical inputs: metrics within
    1e-6, the plotted PNGs equal;
  * run_predict: nerf_label PNGs equal on ≥ 0.99 of the pixels, nerf_image
    within 1 level on ≥ 0.99 of them, seg_label equal (the seg net labels
    the frame's image; for novel viewpoints the render, so ≥ 0.99);
  * train: the files and metric names JAX's loop writes, labels in 1..C;
  * a run killed after an epoch and resumed from its last_ckpt: the same
    bits as the uninterrupted run (both models, both optimizers, the grid,
    the predict PNGs), the bar of tests/test_resume.py.
"""

import argparse
import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_joint_trainer import (C, CFG_KW, MODEL_KW, N_RAYS, SEG_KW,
                                      _check_labels, _start, setup)  # noqa
from ucsa_neural_rendering_tpu.data import scannet_ngp_joint as jds
from ucsa_neural_rendering_tpu.metrics import SemanticsMeter as JMeter
from ucsa_neural_rendering_tpu.train import joint_loop as jloop
from ucsa_neural_rendering_tpu.viz import Visualizer as JVisualizer
from ucsa_neural_rendering_tpu_torch.config import load_yaml
from ucsa_neural_rendering_tpu_torch.data import scannet_ngp_joint as tds
from ucsa_neural_rendering_tpu_torch.data.image_io import read_png
from ucsa_neural_rendering_tpu_torch.data.synthetic import \
    write_synthetic_scene_dir
from ucsa_neural_rendering_tpu_torch.metrics import SemanticsMeter
from ucsa_neural_rendering_tpu_torch.models import DeepLabV3, SemanticNeRF
from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
from ucsa_neural_rendering_tpu_torch.scripts import train_joint as cli
from ucsa_neural_rendering_tpu_torch.train import joint_loop as tloop
from ucsa_neural_rendering_tpu_torch.train.checkpoints import load_tree
from ucsa_neural_rendering_tpu_torch.viz import Visualizer

H, W = 24, 32
SCENE = "scene0000_00"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP_PATH = os.path.join(ROOT, "cfg", "exp", "one_step_joint",
                        "s00_lr1e-5.yml")


class _Recorder:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append({k: float(v) for k, v in metrics.items()})

    def keys(self):
        return [sorted(r) for r in self.records]


@pytest.fixture(scope="module")
def scene_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    scannet = str(root / "scans")
    write_synthetic_scene_dir(scannet, SCENE, n_frames=5, H=H, W=W,
                              color_ext=".png")
    env = {"results": str(root / "results"), "scannet": scannet,
           "scannet_frames_25k": str(root / "frames25k")}
    return env


def _dataset(mod, env, mode, exp_name="loop", **kw):
    only_new = mode in ("train", "predict")
    return mod.ScanNetNGPJoint(root=env["scannet"], scene_list=[SCENE],
                               mode=mode, exp_name=exp_name,
                               only_new_scene=only_new, output_size=(H, W),
                               val_scene_list=None if only_new else [SCENE],
                               **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_test_nerf_matches_jax(setup, scene_env):
    """test_nerf over the 4 train frames in groups of 3 (a partial group
    last): the metrics (measured 1.4e-3 apart at most) and their logged
    names; the rendered labels of those frames."""
    jt, tt, nerf, _, grid = setup
    nerf_state, _ = _start(setup)
    lj, lt = _Recorder(), _Recorder()
    ref = jloop.test_nerf(jt, nerf_state, _dataset(jds, scene_env, "train"),
                          C, lj, "test_pre", occ_grid=grid, group=3)
    got = tloop.test_nerf(tt, _dataset(tds, scene_env, "train"), C, lt,
                          "test_pre", occ_grid=_t(grid), group=3)
    assert lt.keys() == lj.keys()
    np.testing.assert_allclose(got, ref, atol=0.02, rtol=0)
    # the renders themselves, frame by frame
    poses = np.stack([_dataset(tds, scene_env, "train")[i]["pose"]
                      for i in range(4)])
    intr = _dataset(tds, scene_env, "train")[0]["intrinsics"]
    out_j = jt.render_frames(nerf, poses, intr, grid, group=3)
    out_t = tt.render_frames(poses, intr, _t(grid), group=3)
    _check_labels(out_t["nerf_semantics"].numpy(),
                  np.asarray(out_j["nerf_semantics"]),
                  out_t["nerf_semantics_raw"].numpy(),
                  np.asarray(out_j["nerf_semantics_raw"]))


def _pngs(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".png"):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, folder)] = cv2.imread(
                    p, cv2.IMREAD_UNCHANGED)
    return out


@pytest.mark.parametrize("mode", ["val", "train_val"])
def test_validate_seg_matches_jax(setup, scene_env, tmp_path, mode):
    """validate_seg per scene: the metrics, their logged names and the
    plots of the first 2 frames (image, prediction, target, detectron
    overlay) as PNGs."""
    jt, tt, _, _, _ = setup
    _, seg_state = _start(setup)
    lj, lt = _Recorder(), _Recorder()
    vj = JVisualizer(str(tmp_path / "j"), store=True)
    vt = Visualizer(str(tmp_path / "t"), store=True)
    ref = jloop.validate_seg(jt, seg_state, _dataset(jds, scene_env, mode),
                             lambda: JMeter(C), lj, mode, vj, visu_n=2)
    got = tloop.validate_seg(tt, _dataset(tds, scene_env, mode),
                             lambda: SemanticsMeter(C), lt, mode, vt,
                             visu_n=2)
    assert got.keys() == ref.keys() == {SCENE}
    np.testing.assert_allclose(got[SCENE], ref[SCENE], atol=1e-6, rtol=0)
    assert lt.keys() == lj.keys()
    pj, pt = _pngs(str(tmp_path / "j")), _pngs(str(tmp_path / "t"))
    assert pt.keys() == pj.keys() and len(pj) >= 4
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)


@pytest.mark.parametrize("novel", [False, True])
def test_run_predict_matches_jax(setup, scene_env, novel):
    """run_predict over the 5 frames (or their 5 novel viewpoints) in
    groups of 4: the same files; nerf_label equal on ≥ 0.99 of the pixels,
    nerf_image within 1 level on ≥ 0.99, seg_label equal (≥ 0.99 on novel
    viewpoints, where the seg net labels the render); each _vis PNG is its
    label's palette."""
    jt, tt, _, _, grid = setup
    nerf_state, seg_state = _start(setup)
    kw = {"use_novel_viewpoints": novel}
    root_j = os.path.join(scene_env["scannet"], SCENE, "jax_predict")
    root_t = os.path.join(scene_env["scannet"], SCENE, "port_predict")
    jloop.run_predict(jt, nerf_state, seg_state,
                      _dataset(jds, scene_env, "predict", "jax_predict",
                               **kw), root_j, occ_grid=grid)
    tloop.run_predict(tt, _dataset(tds, scene_env, "predict", "port_predict",
                                   **kw), root_t, occ_grid=_t(grid))
    pj, pt = _pngs(root_j), _pngs(root_t)
    assert pt.keys() == pj.keys() and len(pj) == 5 * 5
    sub = "novel_viewpoints" if novel else ""
    for k in range(5):
        one = lambda files, name: files[os.path.join(sub, name, f"{k}.png")]
        lab_t, lab_j = one(pt, "nerf_label"), one(pj, "nerf_label")
        assert (lab_t == lab_j).mean() >= 0.99
        d = np.abs(one(pt, "nerf_image").astype(int)
                   - one(pj, "nerf_image").astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
        seg_t, seg_j = one(pt, "seg_label"), one(pj, "seg_label")
        assert (seg_t == seg_j).mean() >= (0.99 if novel else 1.0)
        assert lab_t.min() >= 1 and lab_t.max() <= C
        for name, lab in (("nerf_label", lab_t), ("seg_label", seg_t)):
            vis = one(pt, name + "_vis")[..., ::-1]  # cv2 reads BGR
            np.testing.assert_array_equal(
                vis, jloop.NYU40_COLOUR_CODE[lab.astype(np.int64)])


# ------------------------------------------------------------- the stage
def _exp(name):
    exp = load_yaml(EXP_PATH)
    exp["general"].update(name=name, checkpoint_load=None)
    exp["trainer"].update(load_from_checkpoint=False, profiler=True)
    exp["model"]["num_classes"] = C
    exp["output_size"] = (H, W)
    exp["data_module"]["batch_size"] = 2
    exp["val_scenes"] = [SCENE]
    return exp


def _models():
    """The tiny models, the same weights on every call (seeded init)."""
    return {"nerf_model": SemanticNeRF(**MODEL_KW, device="cpu"),
            "seg_model": DeepLabV3(**SEG_KW, device="cpu"),
            "n_rays": N_RAYS}


def _run(env, name, exp_name, epochs, resume=False):
    exp = _exp(name)
    exp["trainer"]["resume_from_checkpoint"] = resume
    args = argparse.Namespace(exp_name=exp_name, seed=0, fix_nerf=False,
                              nerf_train_epoch=epochs[0],
                              joint_train_epoch=epochs[1],
                              project_name="t", device="cpu")
    return tloop.train(exp, env, args, render_cfg=RenderConfig(**CFG_KW),
                       trainer_kwargs=_models())


def _jax_metric_names(setup, scene_env):
    """The metric names JAX's loop logs for a 1 + 1 stage: its fit epoch's
    and joint step's loss names (traced with jax.eval_shape, no compile)
    and what its test_nerf and validate_seg log under the loop's
    prefixes."""
    jt, _, _, _, grid = setup
    nerf_state, seg_state = _start(setup)
    ds = _dataset(jds, scene_env, "train")
    batch = jds.ScanNetNGPJoint.collate([ds[0], ds[1]])[1]
    batch = {k: batch[k] for k in ("img", "depth", "pose", "intrinsics",
                                   "one_m_to_scene_uom")}
    key = jax.random.key(0)
    _, fit = jax.eval_shape(lambda ns: jt.nerf_fit_step(
        ns, seg_state, batch, key, grid), nerf_state)
    _, _, joint = jax.eval_shape(lambda ns, ss: jt.joint_step(
        ns, ss, None, batch, None, key, jnp.asarray(grid)), nerf_state,
        seg_state)
    rec = _Recorder()
    jloop.test_nerf(jt, nerf_state, ds, C, rec, "test_pre", grid)
    for prefix in ("val_pre", "val_e1", "train_val_e1"):
        jloop.validate_seg(jt, seg_state, _dataset(jds, scene_env, "val"),
                           lambda: JMeter(C), rec, prefix)
    jloop.test_nerf(jt, nerf_state, ds, C, rec, "test", grid)
    names = [sorted(f"train/{k}" for k in fit)] + rec.keys()
    names.insert(3, sorted(f"train/{k}" for k in joint))
    return names


def test_train_writes_what_jax_writes(setup, scene_env):
    """A 1 + 1 stage: last_ckpt, deeplab_ckpt and nerf_ckpt; one PNG a
    frame in each predict folder (and the empty novel_viewpoints ones);
    metrics.jsonl with JAX's names in JAX's order and finite values;
    profile_steps.jsonl with every phase; labels in 1..C."""
    import json
    trainer, grid = _run(scene_env, "stage", "stage", (1, 1))
    run = os.path.join(scene_env["results"], "stage")
    for ckpt in ("last_ckpt", "deeplab_ckpt", "nerf_ckpt"):
        assert os.path.isfile(os.path.join(run, ckpt, "tree.pt"))
    assert torch.equal(load_tree(os.path.join(run, "nerf_ckpt"))["occ_grid"],
                       grid)
    folder = os.path.join(scene_env["scannet"], SCENE, "stage")
    for name in tloop.PREDICT_SUBFOLDERS:
        assert sorted(os.listdir(os.path.join(folder, name))) == \
            [f"{k}.png" for k in range(5)]
        assert os.listdir(os.path.join(folder, "novel_viewpoints", name)) \
            == []
    for k in range(5):
        lab = read_png(os.path.join(folder, "nerf_label", f"{k}.png"))
        assert lab.dtype == np.uint8 and 1 <= lab.min() and lab.max() <= C
    records = [json.loads(line) for line in open(os.path.join(
        run, "metrics.jsonl"))]
    names = [sorted(k for k in r if k not in ("step", "time"))
             for r in records]
    assert names == _jax_metric_names(setup, scene_env)
    assert all(np.isfinite(v) for r in records for v in r.values())
    tags = [json.loads(line)["tag"] for line in open(os.path.join(
        run, "profile_steps.jsonl"))]
    assert tags == ["nerf_epoch", "test_pre", "val_pre", "joint_epoch",
                    "joint_val", "test_final", "predict_final"]


class _KillAfterSaves:
    """Stands in for joint_loop._save_stage_state: a hard kill right after
    the n-th per-epoch checkpoint write."""

    def __init__(self, n):
        self.n, self.calls, self.real = n, 0, tloop._save_stage_state

    def __call__(self, *args):
        self.real(*args)
        self.calls += 1
        if self.calls >= self.n:
            raise KeyboardInterrupt("simulated kill")


@pytest.fixture(scope="module")
def uninterrupted(scene_env):
    trainer, grid = _run(scene_env, "ref", "ref", (2, 2))
    return copy.deepcopy(trainer.state_dict()), grid.clone()


def _assert_same_bits(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_bits(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_bits(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kill_after", [1, 3])
def test_kill_and_resume_bitmatches_uninterrupted(scene_env, monkeypatch,
                                                  uninterrupted, kill_after):
    """A 2 + 2 stage killed right after its 1st per-epoch save (mid fit) or
    its 3rd (mid joint phase, the seg optimizer in flight), then resumed
    with trainer.resume_from_checkpoint (the run folder kept although
    clean_up_folder_if_exists is set): both models, both optimizers, the
    slab counter, the grid and the predict PNGs have the uninterrupted
    run's bits."""
    name = f"kill{kill_after}"
    killer = _KillAfterSaves(kill_after)
    monkeypatch.setattr(tloop, "_save_stage_state", killer)
    with pytest.raises(KeyboardInterrupt):
        _run(scene_env, name, name, (2, 2))
    monkeypatch.setattr(tloop, "_save_stage_state", killer.real)
    last = load_tree(os.path.join(scene_env["results"], name, "last_ckpt"))
    assert last["done"] == kill_after
    trainer, grid = _run(scene_env, name, name, (2, 2), resume=True)
    ref_state, ref_grid = uninterrupted
    _assert_same_bits(trainer.state_dict(), ref_state)
    assert torch.equal(grid, ref_grid)
    got = _pngs(os.path.join(scene_env["scannet"], SCENE, name))
    ref = _pngs(os.path.join(scene_env["scannet"], SCENE, "ref"))
    assert got.keys() == ref.keys() and got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_cli_reads_the_configs_and_needs_the_card_by_default(
        monkeypatch, tmp_path, capsys):
    """The CLI: without a card the default --device raises before anything
    is read; with --device cpu it loads the experiment and the environment
    through the port's YAML reader (an absolute ENV_WORKSTATION_NAME names
    a file), sets load_pretrain and cuDNN's TF32, and hands the flags to
    joint_loop.train; --help states the precision."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    monkeypatch.setattr(tloop, "train", lambda *a: seen.append(a) or "ran")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--exp", EXP_PATH])
    assert not seen
    (tmp_path / "env.yml").write_text("results: /r\nscannet: /s\n"
                                      "scannet_frames_25k: /f\n")
    monkeypatch.setenv("ENV_WORKSTATION_NAME", str(tmp_path / "env"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert cli.main(["--exp", os.path.relpath(EXP_PATH, ROOT), "--device",
                     "cpu", "--exp_name", "x", "--nerf_train_epoch", "2",
                     "--joint_train_epoch", "3", "--seed", "5"]) == "ran"
    exp, env, args, exp_path, env_path = seen[0]
    ref = load_yaml(EXP_PATH)
    ref["general"]["load_pretrain"] = True
    assert exp == ref and env == {"results": "/r", "scannet": "/s",
                                  "scannet_frames_25k": "/f"}
    assert (args.device, args.exp_name, args.nerf_train_epoch,
            args.joint_train_epoch, args.seed, args.fix_nerf) == \
        ("cpu", "x", 2, 3, 5, False)
    assert exp_path == EXP_PATH and env_path == str(tmp_path / "env.yml")
    assert torch.backends.cudnn.allow_tf32
    with pytest.raises(SystemExit):
        cli.parse_args(["--help"])
    assert "TF32" in capsys.readouterr().out


@pytest.mark.parametrize("what", ["cl_active", "test_25k_split"])
def test_stage_refuses_what_the_next_slice_brings(scene_env, what):
    """Both cases raised NotImplementedError until the continual-learning
    data layer was ported; they now check that working path.
    cl_active: with cl.active: true, build_datamodule's train_joint is the
    ScanNetCLJoint mixer over the scene dataset and the first 25k_fraction
    of split_file_cl's train_cl frames, its items carrying ngp_25k_ratio
    replay frames (image and labels at the output size) and its collate
    the three-way one. test_25k_split: no split file configured, an absent
    one or one with an empty test list give no test set, as in the JAX
    package; a test list gives a test-mode ScanNet over it."""
    from ucsa_neural_rendering_tpu_torch.data import ScanNet, ScanNetCLJoint
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_25k_dir
    exp = _exp("refuse")
    exp["exp_name"] = "refuse"
    f25k = scene_env["scannet_frames_25k"]
    paths = write_synthetic_25k_dir(f25k, n_scenes=1, n_frames_per_scene=4)
    split = os.path.join(f25k, "split.npz")
    split_cl = os.path.join(f25k, "split_cl.npz")
    assert tloop.build_test_25k(exp, scene_env, (H, W)) is None
    try:
        if what == "cl_active":
            exp["cl"].update(active=True, ngp_25k_ratio=2)
            exp["cl"]["25k_fraction"] = 0.5
            np.savez(split_cl, train_cl=np.array(paths))
            dm = tloop.build_datamodule(exp, scene_env, (H, W), [SCENE],
                                        seed=3)
            mixer = dm["train_joint"]
            assert isinstance(mixer, ScanNetCLJoint)
            assert mixer.scannet_25k.image_pths == paths[:2]
            assert mixer.scannet_25k._mode == "train"
            assert mixer.collate is tds.ScanNetNGPJoint.collate
            item = mixer[0]
            assert item["replay_img"].shape == (2, H, W, 3)
            assert item["replay_label"].shape == (2, H, W)
            assert item["replay_img"].dtype == np.float32
            assert item["replay_label"].dtype == np.int32
            assert dm["test_25k"] is None
        else:
            exp["data_module"]["data_preprocessing"]["split_file"] = None
            assert tloop.build_test_25k(exp, scene_env, (H, W)) is None
            exp["data_module"]["data_preprocessing"]["split_file"] = \
                "split.npz"
            np.savez(split, test=np.array([]), train=np.array([]))
            assert tloop.build_test_25k(exp, scene_env, (H, W)) is None
            np.savez(split, test=np.array(paths[1:]))
            dm = tloop.build_datamodule(exp, scene_env, (H, W), [SCENE])
            assert isinstance(dm["test_25k"], ScanNet)
            assert dm["test_25k"]._mode == "test"
            assert dm["test_25k"].image_pths == paths[1:]
            img, label, _ = dm["test_25k"][0]
            assert img.shape == (H, W, 3) and label.shape == (H, W)
            assert isinstance(dm["train_joint"], tds.ScanNetNGPJoint)
    finally:
        for p in (split, split_cl):
            if os.path.exists(p):
                os.remove(p)


def test_logger_timer_and_trace_match_jax(tmp_path):
    """MetricsLogger writes the JAX package's JSONL records (tensors as
    floats), image PNGs of the same names and pixels and the flat
    hyperparameters; StepTimer one line a tick; maybe_trace a Chrome trace
    of its block, nothing when off."""
    import json

    from ucsa_neural_rendering_tpu.utils import MetricsLogger as JLogger
    from ucsa_neural_rendering_tpu_torch.utils import (MetricsLogger,
                                                       StepTimer,
                                                       maybe_trace)
    image = np.random.default_rng(0).integers(0, 256, (6, 8, 3),
                                              dtype=np.uint8)
    for name, make in (("j", JLogger), ("t", MetricsLogger)):
        log = make(str(tmp_path / name))
        log.log({"a": torch.tensor(1.5) if name == "t" else 1.5, "b": 2})
        log.log({"c": 3.0}, step=7)
        log.log_image("val_vis/img", image)
        log.log_image("val_vis/img", image)
        log.log_hyperparams({"x": 1, "y": "z"})
        log.close()
    records = {n: [{k: v for k, v in json.loads(x).items() if k != "time"}
                   for x in open(tmp_path / n / "metrics.jsonl")]
               for n in "jt"}
    assert records["t"] == records["j"] == [{"step": 0, "a": 1.5, "b": 2.0},
                                            {"step": 7, "c": 3.0}]
    pj, pt = _pngs(str(tmp_path / "j")), _pngs(str(tmp_path / "t"))
    assert pt.keys() == pj.keys() and len(pt) == 2
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k])
    assert json.load(open(tmp_path / "t" / "hparams_flat.json")) == \
        json.load(open(tmp_path / "j" / "hparams_flat.json"))
    timer = StepTimer(str(tmp_path / "steps.jsonl"))
    timer.tick("a", epoch=0)
    timer.tick("b")
    timer.close()
    lines = [json.loads(x) for x in open(tmp_path / "steps.jsonl")]
    assert [(x["tag"], x.get("epoch")) for x in lines] == [("a", 0),
                                                           ("b", None)]
    assert all(x["seconds"] >= 0 for x in lines)
    with maybe_trace(False, str(tmp_path / "off")):
        pass
    assert not (tmp_path / "off").exists()
    with maybe_trace(True, str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert "traceEvents" in json.load(open(tmp_path / "trace" /
                                           "trace.json"))
