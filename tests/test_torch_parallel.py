"""Data parallelism of the port (parallel/mesh.py and every `mesh=`) on the
CPU: two ranks spawned over gloo (parallel.dryrun.run_ranks, a `file://`
store under tmp_path) against one rank of the port (mesh=None), whose
numbers the other test_torch_* files hold to JAX.

Each test spawns once and checks several things. The same workload
function runs on the ranks (with their mesh) and here (mesh=None), from
the same seeds. Tolerances: step-1 losses within 1e-5 relative; the
parameters after the steps within 1e-4 of each tensor's max |·|;
BatchNorm running statistics within 1e-5; confusion matrices
exact; and the two ranks' parameters and buffers bit-equal to each other.
The parameters are held after SGD steps: Adam divides each gradient by
its own magnitude, so a rounding-level difference in a near-zero gradient
(a hash-table row that few rays reach, whose terms cancel) becomes a step
of up to lr. The dry run keeps both nets' Adam and holds the ranks to each
other.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu_torch.data import DataLoader, ScanNetCL
from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
from ucsa_neural_rendering_tpu_torch.data.splits import (create_split,
                                                         save_split)
from ucsa_neural_rendering_tpu_torch.data.synthetic import (
    make_synthetic_scene, write_synthetic_25k_dir)
from ucsa_neural_rendering_tpu_torch.models import (TINY_LAYOUT, DeepLabV3,
                                                    SemanticNeRF)
from ucsa_neural_rendering_tpu_torch.ops.renderer import (RenderConfig,
                                                          render_rays,
                                                          render_rays_staged)
from ucsa_neural_rendering_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                             run_ranks)
from ucsa_neural_rendering_tpu_torch.train import (JointTrainer, NeRFTrainer,
                                                   SegTrainer)
from ucsa_neural_rendering_tpu_torch.train import pretrain_loop

C = 5
H, W = 8, 12
LOSS_RTOL = 1e-5
# a later step's losses, and the outputs of the steps' parameters
LATER_RTOL = 1e-4
PARAM_RTOL = 1e-4
BN_ATOL = 1e-5
TIMEOUT = 240


def _seg_model(seed):
    return DeepLabV3(num_classes=C, backbone_layout=TINY_LAYOUT,
                     aspp_channels=8, head_channels=8, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _nerf_model(seed):
    # the exact table gradient: the stochastic one takes a corner by a hash
    # of the position's bits, which a rounding-level change of a fine
    # sample's z (from the last step's rounding) moves
    return SemanticNeRF(bound=1.0, num_semantic_classes=C, n_levels=4,
                        log2_hashmap_size=12, device="cpu",
                        generator=torch.Generator().manual_seed(seed),
                        stochastic_table_grad=False)


def _sgd(trainer, lr):
    """Replace a NeRF trainer's Adam by SGD (module docstring)."""
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr,
                                        momentum=0.9)


def _cpu_state(module):
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def _frames():
    frames, intr = make_synthetic_scene(n_frames=3, H=H, W=W)
    return frames, intr


# ------------------------------------------------------------- workloads
def _nerf_work(mesh):
    """An early-stop staged render and an indivisible render from the
    initial parameters, three train_steps, an occupancy refresh."""
    trainer = NeRFTrainer(_nerf_model(0), RenderConfig(
        num_steps=16, upsample_steps=16, max_ray_batch=48), n_rays=64,
        image_hw=(H, W), device="cpu", mesh=mesh)
    trainer.init()
    _sgd(trainer, 0.01)
    grid = trainer.init_occupancy()
    frames, intr = _frames()
    rays = get_rays(frames[0]["pose"], intr, H, W, device="cpu")
    es = RenderConfig(num_steps=16, upsample_steps=16, max_ray_batch=48,
                      early_stop=True, stage1_steps=4, refine_fraction=0.25)
    staged = render_rays_staged(trainer.model, rays["rays_o"],
                                rays["rays_d"], rays["direction_norms"], es,
                                grid, mesh=mesh)
    odd = render_rays(trainer.model, rays["rays_o"][:7], rays["rays_d"][:7],
                      rays["direction_norms"][:7], trainer.cfg, grid,
                      mesh=mesh)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for k in range(3):
        f = frames[k]
        batch = {"pose": torch.from_numpy(f["pose"]),
                 "intrinsics": torch.from_numpy(intr),
                 "image": torch.from_numpy(f["image"]),
                 "label": torch.from_numpy(f["label"]).long(),
                 "depth": torch.from_numpy(f["depth"]),
                 "one_m_to_scene_uom": 1.0}
        parts = trainer.train_step(batch, gen, grid)
        losses.append({n: float(v) for n, v in parts.items()})
    grid = trainer.update_occupancy(grid, gen)
    return {"staged": staged, "odd": odd, "losses": losses,
            "params": _cpu_state(trainer.model), "grid": grid,
            "gen": gen.get_state()}


def _seg_work(mesh):
    """Three SGD train_steps at batch 4 (synced BN: the ASPP pooling
    branch has n = 2 a rank), then eval_step and the BN trick."""
    trainer = SegTrainer(_seg_model(2), {"name": "SGD", "lr": 0.01,
                                         "sgd_cfg": {"momentum": 0.9}},
                         device="cpu", mesh=mesh)
    trainer.init()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (4, 16, 16, 3))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, C, (4, 16, 16)))
    losses, confs = [], []
    for k in range(3):
        loss, conf = trainer.train_step(images, labels, 0.01,
                                        torch.Generator().manual_seed(k))
        losses.append(float(loss))
        confs.append(conf.cpu())
    preds, logits = trainer.eval_step(images)
    trick, probs = trainer.infer(images, update_bn=True)
    return {"losses": losses, "confs": confs, "eval": (preds, logits),
            "trick": (trick, probs), "state": _cpu_state(trainer.model)}


def _joint_work(mesh):
    """A joint_step whose assembled seg batch (2 rendered + 1 old frame)
    does not divide the ranks, then a fused image step of 2 images."""
    exp = {"optimizer": {"lr_nerf": 1e-2, "lr_seg": 0.01, "name": "SGD",
                         "sgd_cfg": {"momentum": 0.9}}}
    jt = JointTrainer(exp, image_hw=(H, W), num_classes=C,
                      render_cfg=RenderConfig(num_steps=16, upsample_steps=16,
                                              max_ray_batch=48),
                      n_rays=32, nerf_model=_nerf_model(3),
                      seg_model=_seg_model(4), device="cpu", mesh=mesh)
    jt.init()
    _sgd(jt.nerf, 0.01)
    grid = jt.init_occupancy()
    frames, intr = _frames()
    new = {"img": np.stack([f["image"] for f in frames[:2]]),
           "depth": np.stack([f["depth"] for f in frames[:2]]),
           "pose": np.stack([f["pose"] for f in frames[:2]]),
           "intrinsics": np.stack([intr] * 2),
           "one_m_to_scene_uom": np.ones(2, np.float32)}
    old = {"img": frames[2]["image"][None],
           "nerf_label": frames[2]["label"][None]}
    gen = torch.Generator().manual_seed(6)
    logs = jt.joint_step(old, new, None, gen, grid)
    b = jt._batch(new)
    fused = jt.fused_image_step(b["img"], torch.from_numpy(
        np.stack([f["label"] for f in frames[:2]])).long(), b["depth"],
        b["pose"], b["intrinsics"], b["one_m_to_scene_uom"], gen, grid)
    return {"fused": {k: float(v) for k, v in fused.items()},
            "logs": {k: float(v) for k, v in logs.items()},
            "nerf": _cpu_state(jt.nerf.model), "seg": _cpu_state(jt.seg.model)}


def _pretrain_exp(root, name, max_epochs, resume=False):
    return {"general": {"name": name, "clean_up_folder_if_exists": not resume},
            "model": {"num_classes": C},
            "optimizer": {"lr": 0.01, "name": "SGD",
                          "sgd_cfg": {"momentum": 0.9}},
            "trainer": {"max_epochs": max_epochs,
                        "resume_from_checkpoint": resume},
            "data_module": {"batch_size": 4, "shuffle": True,
                            "drop_last": False, "root": root,
                            "data_preprocessing": {"split_file":
                                                   "split.npz"}},
            "output_size": (24, 32)}


def _pretrain_work(mesh, env, tag):
    """pretrain_loop.train on the 25k tree: 2 epochs of 2 steps (6 train
    frames at batch 4, the last batch padded), then the same run cut after
    one epoch and resumed from its last_ckpt."""
    args = argparse.Namespace(seed=0, project_name="t", device="cpu")
    root = env["scannet_frames_25k"]
    whole, best = pretrain_loop.train(
        _pretrain_exp(root, f"{tag}_whole", 2), env, args,
        model=_seg_model(7))
    pretrain_loop.train(_pretrain_exp(root, f"{tag}_cut", 1), env, args,
                        model=_seg_model(7))
    resumed, _ = pretrain_loop.train(
        _pretrain_exp(root, f"{tag}_cut", 2, resume=True), env, args,
        model=_seg_model(7))
    with open(os.path.join(env["results"], f"{tag}_whole",
                           "metrics.jsonl")) as f:
        metrics = f.read()
    return {"whole": _cpu_state(whole.model), "best": best,
            "resumed": _cpu_state(resumed.model), "metrics": metrics}


# ---------------------------------------------------------------- checks
def _close_params(got: dict, ref: dict, rtol=PARAM_RTOL, bn_atol=BN_ATOL):
    for k, r in ref.items():
        g = got[k]
        if not r.is_floating_point():
            assert torch.equal(g, r), k
        elif "running" in k:
            assert (g - r).abs().max() <= bn_atol, k
        else:
            tol = rtol * max(r.abs().max().item(), 1e-12)
            assert (g - r).abs().max() <= tol, (k, (g - r).abs().max(), tol)


def _ranks_equal(results, *keys):
    for key in keys:
        for r in results[1:]:
            a, b = r[key], results[0][key]
            for k in b:
                assert torch.equal(a[k], b[k]), (key, k)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_nerf_steps_and_renders_match_one_rank(tmp_path):
    ref = _nerf_work(None)
    ranks = run_ranks(_nerf_work, 2, str(tmp_path), timeout=TIMEOUT)
    _ranks_equal(ranks, "params")
    for r in ranks:
        for k, v in ref["staged"].items():
            assert torch.allclose(r["staged"][k], v, rtol=1e-5,
                                  atol=1e-6), k
        for k, v in ref["odd"].items():
            assert torch.equal(r["odd"][k], v), k
        for n, v in ref["losses"][0].items():
            assert _rel(r["losses"][0][n], v) <= LOSS_RTOL, n
        _close_params(r["params"], ref["params"])
        assert torch.equal(r["grid"], ranks[0]["grid"])
        assert torch.allclose(r["grid"], ref["grid"], rtol=1e-4, atol=1e-6)
        assert torch.equal(r["gen"], ref["gen"])


def test_seg_steps_with_synced_bn_match_one_rank(tmp_path):
    ref = _seg_work(None)
    ranks = run_ranks(_seg_work, 2, str(tmp_path), timeout=TIMEOUT)
    _ranks_equal(ranks, "state")
    for r in ranks:
        assert _rel(r["losses"][0], ref["losses"][0]) <= LOSS_RTOL
        for a, b in zip(r["confs"], ref["confs"]):
            assert torch.equal(a, b)
        _close_params(r["state"], ref["state"])
        assert torch.equal(r["eval"][0], ref["eval"][0])
        assert torch.allclose(r["eval"][1], ref["eval"][1],
                              rtol=LATER_RTOL, atol=1e-5)
        assert torch.equal(r["trick"][0], ref["trick"][0])
        assert torch.allclose(r["trick"][1], ref["trick"][1],
                              atol=LATER_RTOL)


def test_joint_step_with_indivisible_seg_batch_matches_one_rank(tmp_path):
    ref = _joint_work(None)
    ranks = run_ranks(_joint_work, 2, str(tmp_path), timeout=TIMEOUT)
    _ranks_equal(ranks, "nerf", "seg")
    for r in ranks:
        for part, tol in (("logs", LOSS_RTOL), ("fused", LATER_RTOL)):
            for n, v in ref[part].items():
                assert _rel(r[part][n], v) <= tol, (part, n)
        _close_params(r["nerf"], ref["nerf"])
        _close_params(r["seg"], ref["seg"])


def test_pretrain_epochs_and_resume_match_one_rank(tmp_path):
    f25k = str(tmp_path / "frames25k")
    write_synthetic_25k_dir(f25k, n_scenes=2, n_frames_per_scene=4,
                            H=48, W=64)
    split = create_split(f25k, "/*/color/*.jpg", 0.25, seed=0)
    save_split(split, os.path.join(f25k, "split.npz"))
    env = {"results": str(tmp_path / "results"),
           "scannet_frames_25k": f25k}
    ref = _pretrain_work(None, env, "one")
    ranks = run_ranks(_pretrain_work, 2, str(tmp_path / "ranks"), env,
                      "two", timeout=TIMEOUT)
    _ranks_equal(ranks, "whole", "resumed")
    for r in ranks:
        _close_params(r["whole"], ref["whole"])
        for k, v in r["whole"].items():
            assert torch.equal(r["resumed"][k], v), k
    # rank 0 logged; the epochs' losses and the val mIoU as one rank's
    got = [json.loads(line) for line in ranks[0]["metrics"].splitlines()]
    want = [json.loads(line) for line in ref["metrics"].splitlines()]
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    assert _rel(got[0]["train/loss"], want[0]["train/loss"]) <= LOSS_RTOL
    assert ranks[1]["metrics"] == ranks[0]["metrics"]


def test_dryrun_multichip_twin_over_two_ranks(tmp_path):
    """The __graft_entry__.dryrun_multichip twin: the seg step and the
    joint step over 2 gloo ranks, finite, the ranks' parameters and
    confusion matrices bit-equal."""
    results = dryrun_multichip(2, str(tmp_path), timeout=TIMEOUT)
    assert len(results) == 2


class _Stream:
    """A dataset with a per-item stream (ScanNetNGP's shape)."""

    def __init__(self, n, seed):
        self.n, self._rng = n, np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def plan(self, index):
        return int(self._rng.integers(0, 1000))

    def load(self, index, plan):
        return (np.full((2,), index, np.float32), np.full((2,), plan),
                np.zeros((2,), np.float32))

    def __getitem__(self, index):
        return self.load(index, self.plan(index))


class _Frames25k:
    def __len__(self):
        return 50

    def __getitem__(self, index):
        return (np.full((2,), 100 + index, np.float32),
                np.full((2,), index), np.zeros((2,), np.float32))


@pytest.mark.parametrize("batch_size", [4, 3])
def test_split_loading_keeps_the_global_draws(batch_size):
    """DataLoader.shard over a ScanNetCL mixer: every rank advances the
    scene's and the replay's streams over the whole global batch and reads
    only its block; the blocks in rank order are the unsplit loader's
    batch padded by wraparound, padding rows flagged."""
    def loader(shard=None):
        mix = ScanNetCL(_Frames25k(), _Stream(7, 3), ngp_25k_ratio=2, seed=5)
        dl = DataLoader(mix, batch_size=batch_size, shuffle=True, seed=1,
                        collate_fn=lambda items: items)
        return dl.shard(*shard) if shard else dl

    for epoch in range(2):
        whole = loader()
        whole.set_epoch(epoch)
        parts = []
        for r in range(2):
            dl = loader((r, 2))
            dl.set_epoch(epoch)
            parts.append(list(dl))
        for k, batch in enumerate(whole):
            n = len(batch)
            target = -(-batch_size // 2) * 2
            padded = batch + [batch[j % n] for j in range(target - n)]
            blocks = [parts[r][k] for r in range(2)]
            got = [it for items, _, _ in blocks for it in items]
            flags = np.concatenate([pad for _, pad, _ in blocks])
            assert all(nr == n for _, _, nr in blocks)
            assert flags.tolist() == [j >= n for j in range(target)]
            for a, b in zip(got, padded):
                for x, y in zip((a[0], *a[1]), (b[0], *b[1])):
                    for u, v in zip(x, y):
                        np.testing.assert_array_equal(u, v)
