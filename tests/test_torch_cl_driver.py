"""The port's multi-step continual-learning driver and its CLIs against the
JAX package's, on the CPU.

  * the stage sequence: with joint_loop.train replaced by a recorder on
    both sides, the JAX and the port drivers hand every stage the same
    scenes, run name, checkpoint_load (relative to the results folder),
    load_pretrain, load_from_checkpoint and resume_from_checkpoint, over
    3 scenes, fresh and resumed with stage 0's deeplab_ckpt on disk;
  * a real two-stage protocol in the port (two synthetic rooms at 24×32,
    a 25k tree at 48×64, cl.active with ngp_25k_ratio 1, the tiny models
    of tests/test_torch_joint_trainer.py, 1 + 1 epochs a stage): the
    checkpoints, stage 1 starting from stage 0's deeplab_ckpt bit for bit,
    old-scene frames from stage 0's predict PNGs, a cl batch of JAX's
    shapes in every joint batch, the 25k test under JAX's names; killed
    at stage 1's first last_ckpt save and resumed, the same bits as the
    uninterrupted run (both models, both optimizers, the grid, the
    generator, the predict PNGs);
  * the CLIs: cl_deeplab's flags and defaults, create_split's files
    against the JAX package's split.
"""

import argparse
import copy
import json
import os

import numpy as np
import pytest
import torch

from test_torch_joint_loop import _assert_same_bits, _models, _pngs
from test_torch_joint_trainer import C, CFG_KW, SEG_KW
from ucsa_neural_rendering_tpu.data import scannet_ngp_joint as jds
from ucsa_neural_rendering_tpu.data import splits as jsplits
from ucsa_neural_rendering_tpu.train import cl_driver as jdriver
from ucsa_neural_rendering_tpu.train import joint_loop as jloop
from ucsa_neural_rendering_tpu_torch.config import load_yaml
from ucsa_neural_rendering_tpu_torch.data import scannet_ngp_joint as tds
from ucsa_neural_rendering_tpu_torch.data.splits import (create_split,
                                                         load_split,
                                                         save_split)
from ucsa_neural_rendering_tpu_torch.data.synthetic import (
    write_synthetic_25k_dir, write_synthetic_scene_dir)
from ucsa_neural_rendering_tpu_torch.models import DeepLabV3
from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
from ucsa_neural_rendering_tpu_torch.scripts import cl_deeplab
from ucsa_neural_rendering_tpu_torch.scripts import create_split as split_cli
from ucsa_neural_rendering_tpu_torch.train import JointTrainer
from ucsa_neural_rendering_tpu_torch.train import cl_driver as tdriver
from ucsa_neural_rendering_tpu_torch.train import joint_loop as tloop
from ucsa_neural_rendering_tpu_torch.train.checkpoints import (load_deeplab,
                                                               load_tree,
                                                               save_deeplab)

H, W = 24, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CL_EXP = os.path.join(ROOT, "cfg", "exp", "multi_step", "cl_base.yml")
ROOMS = ["scene0000_00", "scene0001_00"]
METRICS_25K = ("test/25k_mean_IoU", "test/25k_total_accuracy",
               "test/25k_mean_accuracy")


def _args(exp_name, device="cpu"):
    return argparse.Namespace(exp_name=exp_name, seed=0, fix_nerf=False,
                              nerf_train_epoch=1, joint_train_epoch=1,
                              project_name="t", device=device)


# ------------------------------------------------------ the stage sequence
def _record_stages(driver, loop, monkeypatch, env, resume):
    """The per-stage snapshots of what `driver` hands joint_loop.train, and
    its results' skipped stages."""
    seen = []

    def recorder(exp, env_, args, *a, **kw):
        g, t = exp["general"], exp["trainer"]
        ck = g["checkpoint_load"]
        if ck and os.path.isabs(ck):
            ck = os.path.relpath(ck, env["results"])
        seen.append({"scenes": list(exp["scenes"]), "name": g["name"],
                     "checkpoint_load": ck,
                     "load_pretrain": g["load_pretrain"],
                     "load_from_checkpoint": t["load_from_checkpoint"],
                     "resume_from_checkpoint": t["resume_from_checkpoint"],
                     "kwargs": sorted(kw)})
        return None, None

    monkeypatch.setattr(loop, "train", recorder)
    exp = load_yaml(CL_EXP)
    exp["trainer"]["resume_from_checkpoint"] = resume
    results = driver.main(exp, env, _args("seq"),
                          scene_order=["scene0000_00", "scene0001_00",
                                       "scene0002_00"],
                          render_cfg="rc", val_scene_list=["v"],
                          trainer_kwargs={})
    return seen, [r is None for r in results]


@pytest.mark.parametrize("resume", [False, True])
def test_stage_sequence_matches_jax(monkeypatch, tmp_path, resume):
    """Fresh: three stages, stage 0 from the pretrained checkpoint, each
    later one from the previous stage's deeplab_ckpt. Resumed with stage
    0's deeplab_ckpt on disk: stage 0 skipped (None in the results), stage
    1 resumes, stage 2 starts fresh."""
    snaps = {}
    for name, driver, loop in (("jax", jdriver, jloop),
                               ("port", tdriver, tloop)):
        env = {"results": str(tmp_path / name)}
        if resume:
            os.makedirs(os.path.join(env["results"], "seq", "stage_0",
                                     "deeplab_ckpt"))
        snaps[name] = _record_stages(driver, loop, monkeypatch, env, resume)
    assert snaps["port"] == snaps["jax"]
    seen, skipped = snaps["port"]
    assert skipped == [resume, False, False]
    assert [s["checkpoint_load"] for s in seen] == (
        [] if resume else ["ckpts/pretrained_deeplab"]) + [
        os.path.join("seq", "stage_0", "deeplab_ckpt"),
        os.path.join("seq", "stage_1", "deeplab_ckpt")]
    assert [s["resume_from_checkpoint"] for s in seen] == \
        ([True, False] if resume else [False] * 3)


# ------------------------------------------------- a two-stage protocol
@pytest.fixture(scope="module")
def protocol_env(tmp_path_factory):
    """Two synthetic rooms (5 frames of 24×32, PNG colour; the second in
    another palette of the same 6 classes), a 25k tree (2 scenes × 4
    frames of 48×64) with its split files, and a tiny seg net saved as the
    pretrained checkpoint."""
    root = tmp_path_factory.mktemp("protocol")
    env = {"results": str(root / "results"), "scannet": str(root / "scans"),
           "scannet_frames_25k": str(root / "frames25k")}
    for room, variant in zip(ROOMS, (0, 7)):
        write_synthetic_scene_dir(env["scannet"], room, n_frames=5, H=H, W=W,
                                  variant=variant, color_ext=".png")
    f25k = env["scannet_frames_25k"]
    write_synthetic_25k_dir(f25k, n_scenes=2, n_frames_per_scene=4)
    split = create_split(f25k, "/*/color/*.jpg", 0.2, seed=0)
    save_split(split, os.path.join(f25k, "split.npz"))
    save_split({"train_cl": split["train_cl"]},
               os.path.join(f25k, "split_cl.npz"))
    ckpt = str(root / "pretrained")
    save_deeplab(ckpt, DeepLabV3(**SEG_KW, device="cpu",
                                 generator=torch.Generator().manual_seed(5))
                 .state_dict())
    return env, ckpt


def _protocol_exp(ckpt, resume=False):
    exp = load_yaml(CL_EXP)
    del exp["renderer"]  # the tiny render config is passed instead
    exp["general"]["checkpoint_load"] = ckpt
    exp["trainer"].update(profiler=True, resume_from_checkpoint=resume)
    exp["model"]["num_classes"] = C
    exp["output_size"] = (H, W)
    exp["val_scenes"] = list(ROOMS)
    exp["cl"]["25k_fraction"] = 1.0
    return exp


class _Watch:
    """Records, per stage, the seg weights right after JointTrainer.init,
    each joint batch's parts, and the old-scene label files read."""

    def __init__(self, monkeypatch):
        self.init, self.batches, self.reads = [], [], []
        init, step = JointTrainer.init, JointTrainer.joint_step
        read = tds.ScanNetNGPJoint._read_label

        def on_init(trainer, *a, **kw):
            init(trainer, *a, **kw)
            self.init.append(copy.deepcopy(trainer.seg.model.state_dict()))
            self.batches.append([])
            self.reads.append([])

        def on_step(trainer, old, new, cl, *a, **kw):
            self.batches[-1].append({
                "old": None if old is None else len(old["img"]),
                "new": None if new is None else len(new["img"]),
                "cl": None if cl is None else {
                    k: (v.shape, v.dtype) for k, v in cl.items()}})
            return step(trainer, old, new, cl, *a, **kw)

        def on_read(ds, path):
            self.reads[-1].append(path)
            return read(ds, path)

        monkeypatch.setattr(JointTrainer, "init", on_init)
        monkeypatch.setattr(JointTrainer, "joint_step", on_step)
        monkeypatch.setattr(tds.ScanNetNGPJoint, "_read_label", on_read)


def _protocol(env, ckpt, exp_name, resume=False):
    return tdriver.main(_protocol_exp(ckpt, resume), env, _args(exp_name),
                        scene_order=ROOMS, render_cfg=RenderConfig(**CFG_KW),
                        trainer_kwargs=_models())


@pytest.fixture(scope="module")
def uninterrupted(protocol_env):
    mp = pytest.MonkeyPatch()
    try:
        watch = _Watch(mp)
        results = _protocol(*protocol_env, "ref")
    finally:
        mp.undo()
    return results, watch


def _jax_cl_batch(env, ckpt):
    """The cl batch JAX's data module collates for stage 0's first joint
    batch: {key: (shape, dtype)}."""
    exp = _protocol_exp(ckpt)
    exp["exp_name"], exp["scenes"] = "jax_shapes", ROOMS[:1]
    dm = jloop.build_datamodule(exp, env, (H, W), list(ROOMS), seed=0)
    _, _, cl = jds.ScanNetNGPJoint.collate([dm["train_joint"][i]
                                            for i in (0, 1)])
    return {k: (v.shape, v.dtype) for k, v in cl.items()}


def test_protocol_runs_two_stages(protocol_env, uninterrupted):
    """Both stages' checkpoints; stage 0 starts from the pretrained net and
    stage 1 from stage 0's deeplab_ckpt, bit for bit; stage 1's joint
    batches hold old-scene frames and it reads stage 0's predict labels;
    every joint batch holds a cl batch of JAX's shapes and dtypes;
    test/25k_* logged in both stages, finite and in [0, 1]."""
    env, ckpt = protocol_env
    results, watch = uninterrupted
    assert results == [os.path.join(env["results"], "ref", s)
                       for s in ("stage_0", "stage_1")]
    for run in results:
        for name in ("deeplab_ckpt", "nerf_ckpt", "last_ckpt"):
            assert os.path.isfile(os.path.join(run, name, "tree.pt")), name
    assert len(watch.init) == 2
    _assert_same_bits(watch.init[0], load_deeplab(ckpt))
    _assert_same_bits(watch.init[1], load_deeplab(os.path.join(
        results[0], "deeplab_ckpt")))
    cl_ref = _jax_cl_batch(env, ckpt)
    assert cl_ref["replay_img"][0] == (2, 1, H, W, 3)
    for stage, batches in enumerate(watch.batches):
        assert batches and all(b["cl"] == cl_ref for b in batches)
        assert any(b["old"] for b in batches) == (stage == 1)
    dumps = os.path.join(env["scannet"], ROOMS[0], "ref", "nerf_label")
    assert not any(p.startswith(dumps) for p in watch.reads[0])
    assert any(p.startswith(dumps) for p in watch.reads[1])
    for run in results:
        records = [json.loads(x) for x in open(os.path.join(
            run, "metrics.jsonl"))]
        test_25k = [r for r in records if any("25k" in k for k in r)]
        assert len(test_25k) == 1
        values = {k: v for k, v in test_25k[0].items()
                  if k not in ("step", "time")}
        assert sorted(values) == sorted(METRICS_25K)
        assert all(0.0 <= v <= 1.0 for v in values.values())
        tags = [json.loads(x)["tag"] for x in open(os.path.join(
            run, "profile_steps.jsonl"))]
        assert tags == ["nerf_epoch", "test_pre", "val_pre", "joint_epoch",
                        "joint_val", "test_final", "test_25k",
                        "predict_final"]


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


def test_killed_protocol_resumes_to_the_same_bits(protocol_env, uninterrupted,
                                                  monkeypatch):
    """Killed right after stage 1's first last_ckpt save (the 3rd save of
    the protocol), then called again with resume_from_checkpoint: stage 0
    is skipped (None in the results, its files untouched) and stage 1 ends
    with the uninterrupted run's bits: its last_ckpt (both models, both
    optimizers, the slab counter, the grid, the generator), nerf_ckpt and
    deeplab_ckpt, and both stages' predict PNGs."""
    env, ckpt = protocol_env
    killer = _KillAfterSaves(3)
    monkeypatch.setattr(tloop, "_save_stage_state", killer)
    with pytest.raises(KeyboardInterrupt):
        _protocol(env, ckpt, "kill")
    monkeypatch.setattr(tloop, "_save_stage_state", killer.real)
    stage0 = os.path.join(env["results"], "kill", "stage_0")
    assert load_tree(os.path.join(env["results"], "kill", "stage_1",
                                  "last_ckpt"))["done"] == 1
    mtimes = {f: os.path.getmtime(os.path.join(d, f))
              for d, _, fs in os.walk(stage0) for f in fs}
    results = _protocol(env, ckpt, "kill", resume=True)
    assert results[0] is None and results[1].endswith("stage_1")
    assert {f: os.path.getmtime(os.path.join(d, f))
            for d, _, fs in os.walk(stage0) for f in fs} == mtimes
    ref = uninterrupted[0][1]
    for name in ("last_ckpt", "nerf_ckpt", "deeplab_ckpt"):
        _assert_same_bits(load_tree(os.path.join(results[1], name)),
                          load_tree(os.path.join(ref, name)))
    for room in ROOMS:
        got = _pngs(os.path.join(env["scannet"], room, "kill"))
        want = _pngs(os.path.join(env["scannet"], room, "ref"))
        assert got.keys() == want.keys() and got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- the CLIs
def test_cl_cli_reads_the_configs_and_needs_the_card_by_default(
        monkeypatch, tmp_path, capsys):
    """cl_deeplab: --device defaults to cuda, which raises without a card
    before anything is read; with --device cpu it loads the experiment and
    the environment through the port's reader, sets cuDNN's TF32 and hands
    the JAX CLI's flags to cl_driver.main unchanged; --help states the
    precision."""
    assert cl_deeplab.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    monkeypatch.setattr(tdriver, "main", lambda *a: seen.append(a) or "ran")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cl_deeplab.main([])
    assert not seen
    (tmp_path / "env.yml").write_text("results: /r\nscannet: /s\n"
                                      "scannet_frames_25k: /f\n")
    monkeypatch.setenv("ENV_WORKSTATION_NAME", str(tmp_path / "env"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert cl_deeplab.main(["--device", "cpu", "--exp_name", "x",
                            "--nerf_train_epoch", "2", "--joint_train_epoch",
                            "3", "--seed", "5", "--fix_nerf"]) == "ran"
    exp, env, args, exp_path, env_path = seen[0]
    assert exp == load_yaml(CL_EXP) and env == {
        "results": "/r", "scannet": "/s", "scannet_frames_25k": "/f"}
    assert (args.device, args.exp_name, args.nerf_train_epoch,
            args.joint_train_epoch, args.seed, args.fix_nerf,
            args.project_name) == ("cpu", "x", 2, 3, 5, True,
                                   "test_one_by_one")
    assert exp_path == CL_EXP and env_path == str(tmp_path / "env.yml")
    assert torch.backends.cudnn.allow_tf32
    with pytest.raises(SystemExit):
        cl_deeplab.parse_args(["--help"])
    assert "TF32" in capsys.readouterr().out


def test_create_split_cli_writes_jax_splits(monkeypatch, tmp_path):
    """create_split: split.npz (train / val / test / train_cl) and
    split_cl.npz (train_cl) under the environment's scannet_frames_25k,
    equal to the JAX package's create_split of the configured root and
    seed."""
    f25k = str(tmp_path / "f25k")
    write_synthetic_25k_dir(f25k, n_scenes=3, n_frames_per_scene=4, H=8,
                            W=10)
    cfg = load_yaml(CL_EXP)
    (tmp_path / "exp.yml").write_text(
        "data_module:\n"
        f"  root: {f25k}\n"
        "  data_preprocessing:\n"
        "    val_ratio: 0.25\n"
        f"    image_regex: {cfg['data_module']['data_preprocessing']['image_regex']}\n"  # noqa: E501
        "    split_file: split.npz\n"
        "    split_file_cl: split_cl.npz\n")
    out = str(tmp_path / "out")
    (tmp_path / "env.yml").write_text(f"results: /r\nscannet: /s\n"
                                      f"scannet_frames_25k: {out}\n")
    monkeypatch.setenv("ENV_WORKSTATION_NAME", str(tmp_path / "env"))
    paths = split_cli.main(["--config", str(tmp_path / "exp.yml"),
                            "--seed", "3"])
    assert paths == (os.path.join(out, "split.npz"),
                     os.path.join(out, "split_cl.npz"))
    ref = jsplits.create_split(f25k, "/*/color/*.jpg", 0.25, seed=3)
    got = load_split(paths[0])
    assert got.keys() == ref.keys() and len(ref["test"]) == 3
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    got_cl = load_split(paths[1])
    assert list(got_cl) == ["train_cl"]
    np.testing.assert_array_equal(got_cl["train_cl"], ref["train_cl"])
