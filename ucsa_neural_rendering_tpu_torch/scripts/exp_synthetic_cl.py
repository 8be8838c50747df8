"""Multi-stage continual-learning experiment on synthetic scenes (the port's
counterpart of scripts/exp_synthetic_cl.py, with its flags, defaults, arm
names, directory layout and JSON files, plus --device), on the card unless
--device cpu.

The reference's headline experiment is a 10-scene ScanNet continual-learning
run: pretrain DeepLab on scannet_frames_25k, then per scene fit a
Semantic-NeRF on the seg model's pseudo-labels, joint-train with rendered
replay, and track per-scene val mIoU over stages. This script reproduces the
experiment's structure on analytic cube rooms (`data.synthetic.scene_palette`
variants): each stage's scene has six wall classes and colours no earlier
stage saw, so stability (old-scene mIoU) and plasticity (new-scene mIoU) are
both measurable, with and without replay.

Phases, one process each (scripts/quality_gate.py chains them):

  python -m ucsa_neural_rendering_tpu_torch.scripts.exp_synthetic_cl \\
      --phase data
  ... --phase pretrain
  ... --phase stage --stage-idx 0
  ...
  ... --phase report

or `--phase all` to run everything in one process (each stage's trainers
are dropped before the next stage starts). Results land in
<root>/experiments/<arm>/stage_i/{metrics.jsonl, final_val.json}, and the
report phase assembles the stage x scene val-mIoU matrix into
<root>/experiments/report_<arm>.json. A stage prints the kernel launches
it made, one JSON line.
"""

import argparse
import gc
import json
import os
import sys

NUM_CLASSES = 40
DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "ucsa_cl_exp")
# the data and report phases touch no device and import no torch (a
# process of the gate's chain that reads JSON should not pay for it)
PRECISION = ("Precision: the pretrain and stage phases set cuDNN's TF32 on "
             "for the segmentation net's convolutions, as the port's other "
             "CLIs do; the NeRF runs in f32 with its MLP products in bf16.")


def parse_hw(s):
    h, w = s.lower().split("x")
    return int(h), int(w)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                epilog=PRECISION)
    p.add_argument("--root", default=DEFAULT_ROOT,
                   help="where the data, runs and reports go (default: "
                        "build/ucsa_cl_exp under the repository)")
    p.add_argument("--phase", default="all",
                   choices=["data", "pretrain", "stage", "report", "all"])
    p.add_argument("--stage-idx", type=int, default=None,
                   help="with --phase stage: which stage to run")
    p.add_argument("--scenes", type=int, default=3)
    p.add_argument("--hw", type=parse_hw, default=(240, 320),
                   help="HxW, e.g. 240x320 (card) or 48x64 (CPU)")
    p.add_argument("--frames", type=int, default=8, help="frames per scene")
    p.add_argument("--tiny", action="store_true",
                   help="tiny seg backbone + small NeRF (CPU-sized)")
    p.add_argument("--seg-tiny", action="store_true",
                   help="tiny seg backbone but FULL-SIZE NeRF + budgets: "
                        "the render-config quality gate varies the NeRF "
                        "side, and a from-scratch R101 cannot reach a "
                        "useful operating point on the tiny synthetic "
                        "corpus (no ImageNet init here)")
    p.add_argument("--replay", choices=["on", "off"], default="on",
                   help="CL replay arm: rendered replay + 25k fraction (the "
                        "reference protocol) vs naive finetuning")
    p.add_argument("--enc", default="16x2",
                   help="hash-encoding geometry LxF at constant L*F=32 "
                        "output (full-size arms only): 16x2 (reference), "
                        "8x4, 4x8")
    p.add_argument("--render-arm",
                   choices=["accel", "dense", "ladder", "face", "proposal"],
                   default="accel",
                   help="render/train configuration arm for the quality "
                        "gate: 'accel' = occupancy 32+32, 'dense' = the "
                        "reference's 256+256 stratified+importance with "
                        "occupancy off, 'ladder' = accel + fully "
                        "stochastic-forward encoding, 'face' = accel + "
                        "stratified face-sampled forward (4 rows, exact "
                        "bilinear face blend), 'proposal' = grid-density "
                        "proposal placement of --occ-steps TOTAL samples "
                        "in one draw, one full-model pass")
    p.add_argument("--occ-steps", type=int, default=32,
                   help="occupancy-sampling budget per pass (coarse AND "
                        "refine): 32 = the 32+32 default; 24/16 = the "
                        "reduced-budget gate arms (rows scale linearly "
                        "with the budget)")
    p.add_argument("--pretrain-epochs", type=int, default=30)
    p.add_argument("--pretrain-lr", type=float, default=1e-3,
                   help="the reference pretrains at 1e-4 for 150 epochs on "
                        "25k images; the tiny synthetic corpus needs a "
                        "hotter schedule to reach a comparable operating "
                        "point in hundreds of steps")
    p.add_argument("--nerf-epochs", type=int, default=15)
    p.add_argument("--joint-epochs", type=int, default=5)
    p.add_argument("--frame-gain", type=float, default=0.25,
                   help="per-frame exposure gain range (U(1-g,1+g)) — makes "
                        "pseudo-label errors view-dependent so NeRF fusion "
                        "has something to denoise")
    p.add_argument("--pixel-noise", type=float, default=0.05)
    p.add_argument("--lr-seg", type=float, default=1e-5,
                   help="joint-stage seg LR (reference cl_base.yml: 1e-5)")
    p.add_argument("--lr-nerf", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu "
                        "(the plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def scene_names(n):
    return [f"scene{i:04d}_00" for i in range(n)]


def arm_name(a):
    base = f"cl_replay_{a.replay}"
    if a.render_arm != "accel":
        base += f"_{a.render_arm}"
    if getattr(a, "enc", "16x2") != "16x2":
        base += f"_enc{a.enc}"
    if getattr(a, "occ_steps", 32) != 32:
        base += f"_occ{a.occ_steps}"
    return base


def env_dict(a):
    return {"results": os.path.join(a.root, "experiments"),
            "scannet": os.path.join(a.root, "scans"),
            "scannet_frames_25k": os.path.join(a.root, "frames25k")}


def models_for(a, num_classes=NUM_CLASSES):
    """(seg_model, trainer_kwargs-for-joint) on a.device, drawn from
    a.seed (the NeRF from seed, the seg net from seed + 1, as
    joint_loop.train draws its own). Full-size by default; --tiny swaps the
    structurally identical small layouts the tests use."""
    import torch
    from ..models import TINY_LAYOUT, DeepLabV3, SemanticNeRF
    from ..utils.device import resolve_device
    device = resolve_device(getattr(a, "device", "cuda"))
    seeded = lambda k: torch.Generator().manual_seed(a.seed + k)
    # the ladder arm trains with the fully stochastic-forward encoding; the
    # face arm with the stratified one-axis face estimator
    sfwd = {"ladder": True, "face": "face"}.get(
        getattr(a, "render_arm", "accel"), False)
    tiny_seg = dict(num_classes=num_classes, backbone_layout=TINY_LAYOUT,
                    aspp_channels=32, head_channels=32)
    if a.tiny:
        seg = DeepLabV3(**tiny_seg, device=device, generator=seeded(1))
        nerf = SemanticNeRF(bound=1.0, num_semantic_classes=num_classes,
                            n_levels=8, log2_hashmap_size=15,
                            stochastic_fwd=sfwd, device=device,
                            generator=seeded(0))
        n_rays = 1024
    else:
        L, F = (int(x) for x in getattr(a, "enc", "16x2").split("x"))
        if getattr(a, "seg_tiny", False):
            seg = DeepLabV3(**tiny_seg, device=device, generator=seeded(1))
        else:
            seg = DeepLabV3(num_classes=num_classes, device=device,
                            generator=seeded(1))
        nerf = SemanticNeRF(bound=4.0, num_semantic_classes=num_classes,
                            n_levels=L, n_features=F, stochastic_fwd=sfwd,
                            device=device, generator=seeded(0))
        n_rays = 4096
    return seg, {"seg_model": seg, "nerf_model": nerf, "n_rays": n_rays}


def render_cfg_for(a):
    from ..ops.renderer import RenderConfig
    h, w = a.hw
    if getattr(a, "render_arm", "accel") == "dense":
        # the reference's dense stratified+importance budget (occupancy off
        # via exp["nerf"]["use_occupancy"] in joint_exp)
        if a.tiny:
            return RenderConfig(num_steps=64, upsample_steps=64,
                                max_ray_batch=h * w)
        return RenderConfig(num_steps=256, upsample_steps=256)
    if getattr(a, "render_arm", "accel") == "proposal":
        # --occ-steps is the TOTAL budget here, split 3:1 between the
        # grid-CDF proposal placement and a small importance refine
        if a.tiny:
            return RenderConfig(num_steps=18, upsample_steps=6,
                                proposal_placement=True, max_ray_batch=h * w)
        total = getattr(a, "occ_steps", 32)
        return RenderConfig(num_steps=max(1, total * 3 // 4),
                            upsample_steps=total // 4,
                            proposal_placement=True)
    if a.tiny:
        return RenderConfig(num_steps=24, upsample_steps=24,
                            max_ray_batch=h * w)
    s = getattr(a, "occ_steps", 32)
    return RenderConfig(num_steps=s, upsample_steps=s)


def phase_data(a):
    from ..data.splits import create_split, save_split
    from ..data.synthetic import (write_synthetic_25k_dir,
                                  write_synthetic_scene_dir)
    env = env_dict(a)
    h, w = a.hw
    if a.scenes > 6:
        raise ValueError("--scenes: 7+ scenes wrap the 7 class families")
    # CL scenes are variants 1..N; the pretrain/replay corpus holds their
    # family twins (k+7, k+14): same classes, different colour jitter, so
    # the pretrained model transfers imperfectly to each CL scene, like a
    # 25k-pretrained DeepLab on an unseen ScanNet room
    cl_variants = list(range(1, a.scenes + 1))
    corpus_variants = [k + 7 for k in cl_variants] + \
                      [k + 14 for k in cl_variants]
    for i, scene in enumerate(scene_names(a.scenes)):
        write_synthetic_scene_dir(env["scannet"], scene, n_frames=a.frames,
                                  H=h, W=w, variant=cl_variants[i],
                                  frame_gain=a.frame_gain,
                                  pixel_noise=a.pixel_noise)
    os.makedirs(env["scannet_frames_25k"], exist_ok=True)
    write_synthetic_25k_dir(env["scannet_frames_25k"],
                            n_scenes=len(corpus_variants),
                            n_frames_per_scene=a.frames, H=h, W=w,
                            variants=corpus_variants,
                            frame_gain=a.frame_gain,
                            pixel_noise=a.pixel_noise)
    split = create_split(env["scannet_frames_25k"], val_ratio=0.25,
                         seed=a.seed)
    for name in ("split.npz", "split_cl.npz"):
        save_split(split, os.path.join(env["scannet_frames_25k"], name))
    print(f"[data] {a.scenes} scenes @ {h}x{w}, {a.frames} frames each, "
          f"25k corpus + splits under {a.root}")


def pretrain_exp(a):
    return {
        "general": {"name": "pretrain25k", "clean_up_folder_if_exists": True,
                    "checkpoint_load": None},
        "model": {"num_classes": 40},
        # the reference's pretrain yaml shape: Adam + POLY to 1e-6 (lr
        # rescaled for the synthetic corpus via --pretrain-lr)
        "optimizer": {"lr": a.pretrain_lr, "name": "Adam"},
        "lr_scheduler": {"active": True, "name": "POLY",
                         "poly_cfg": {"power": 0.9,
                                      "max_epochs": a.pretrain_epochs,
                                      "target_lr": 1e-6}},
        "trainer": {"max_epochs": a.pretrain_epochs,
                    # no resume anchors on the tiny corpus
                    "save_last": False},
        "data_module": {"root": env_dict(a)["scannet_frames_25k"],
                        "batch_size": 4, "drop_last": False,
                        "data_preprocessing": {"split_file": "split.npz"}},
        "output_size": list(a.hw),
    }


def _release(device):
    """Free what a finished phase held before the next one starts: the
    trainers must be unreferenced by then (a stage that pins the previous
    one doubles the memory of every stage after it)."""
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def phase_pretrain(a):
    from ..train import pretrain_loop
    seg = models_for(a)[0]
    args = argparse.Namespace(seed=a.seed, project_name="pretrain",
                              device=a.device)
    pretrain_exp_d = pretrain_exp(a)
    pretrain_loop.train(pretrain_exp_d, env_dict(a), args, model=seg)
    del seg
    _release(a.device)
    print("[pretrain] done ->",
          os.path.join(env_dict(a)["results"], "pretrain25k"))


def joint_exp(a, stage_i):
    env = env_dict(a)
    arm = arm_name(a)
    replay = a.replay == "on"
    exp = {
        "general": {"name": f"{arm}/stage_{stage_i}",
                    "clean_up_folder_if_exists": True,
                    "load_pretrain": stage_i == 0},
        "model": {"num_classes": 40},
        "lr_scheduler": {"active": False},
        # reference multi_step cl_base.yml: Adam, lr_seg 1e-5, lr_nerf 1e-2
        "optimizer": {"lr_seg": a.lr_seg, "lr_nerf": a.lr_nerf,
                      "name": "Adam"},
        "trainer": {"max_epochs": a.joint_epochs,
                    "resume_from_checkpoint": False,
                    "load_from_checkpoint": True,
                    # no per-epoch resume anchors in the experiment harness
                    "save_last": False},
        "data_module": {"batch_size": 2, "shuffle": True, "num_workers": 0,
                        "drop_last": True,
                        "data_preprocessing": {"split_file": "split.npz",
                                               "split_file_cl":
                                                   "split_cl.npz"}},
        "visualizer": {"store": False,
                       "store_n": {"train": 0, "val": 0, "test": 0}},
        "scenes": scene_names(stage_i + 1),
        "cl": {"active": replay, "25k_fraction": 1.0,
               "ngp_25k_ratio": 1, "use_novel_viewpoints": False,
               "replay_buffer_size": 100 if replay else 0},
        "output_size": list(a.hw),
        "exp_name": arm,
        # dense arm = reference-parity sampling (occupancy placement off)
        "nerf": {"use_occupancy": a.render_arm != "dense"},
    }
    if stage_i == 0:
        exp["general"]["checkpoint_load"] = os.path.join(
            env["results"], "pretrain25k", "best_ckpt")
    else:
        exp["general"]["checkpoint_load"] = os.path.join(
            env["results"], arm, f"stage_{stage_i - 1}", "deeplab_ckpt")
    return exp


def phase_stage(a, stage_i):
    """One stage through joint_loop.train, then the final model's val mIoU
    on every scene into final_val.json. Prints the stage's kernel launches
    and returns the final_val dict."""
    from .. import kernels
    from ..metrics import SemanticsMeter
    from ..train import joint_loop
    tkw = models_for(a)[1]
    exp = joint_exp(a, stage_i)
    env = env_dict(a)
    args = argparse.Namespace(exp_name=arm_name(a), seed=a.seed,
                              fix_nerf=False, nerf_train_epoch=a.nerf_epochs,
                              joint_train_epoch=a.joint_epochs,
                              project_name="cl_exp", device=a.device)
    kernels.reset_launches()
    trainer, _ = joint_loop.train(exp, env, args,
                                  render_cfg=render_cfg_for(a),
                                  val_scene_list=scene_names(a.scenes),
                                  trainer_kwargs=tkw)
    del tkw
    # end-of-stage model quality on EVERY scene's val split (the stage's own
    # in-loop val runs every check_val_every_n_epoch joint epochs; the CL
    # matrix needs the final model regardless of epoch count)
    exp_eval = dict(exp, scenes=scene_names(a.scenes))
    dm = joint_loop.build_datamodule(exp_eval, env, a.hw,
                                     val_scene_list=scene_names(a.scenes),
                                     seed=a.seed)
    results = joint_loop.validate_seg(trainer, dm["val"],
                                      lambda: SemanticsMeter(NUM_CLASSES),
                                      None, "final")
    del trainer, dm
    _release(a.device)
    final = {scene: {"mIoU": m, "total_acc": t, "mean_acc": c}
             for scene, (m, t, c) in results.items()}
    dst = os.path.join(env["results"], arm_name(a), f"stage_{stage_i}",
                       "final_val.json")
    with open(dst, "w") as f:
        json.dump(final, f, indent=2)
    print(f"[stage {stage_i}] final per-scene val mIoU:",
          {s: round(v["mIoU"], 4) for s, v in final.items()})
    print(f"[stage {stage_i}] kernel launches: "
          + json.dumps({k: v for k, v in kernels.LAUNCHES.items() if v}))
    return final


def phase_report(a):
    """Assemble the stage x scene val-mIoU matrix from each stage's
    final_val.json. Returns the report."""
    env = env_dict(a)
    arm = arm_name(a)
    scenes = scene_names(a.scenes)
    matrix = {}
    for i in range(a.scenes):
        stage_dir = os.path.join(env["results"], arm, f"stage_{i}")
        final = os.path.join(stage_dir, "final_val.json")
        if not os.path.exists(final):
            print(f"[report] missing {final}; ran --phase stage "
                  f"--stage-idx {i}?")
            continue
        with open(final) as f:
            row = {s: v["mIoU"] for s, v in json.load(f).items()}
        matrix[f"stage_{i}"] = row
    out = {"arm": arm, "hw": list(a.hw), "scenes": scenes,
           "frames_per_scene": a.frames, "tiny": a.tiny,
           "pretrain_epochs": a.pretrain_epochs,
           "nerf_epochs": a.nerf_epochs, "joint_epochs": a.joint_epochs,
           "val_mIoU": matrix}
    # summary scalars: plasticity = mean mIoU on each stage's NEW scene at
    # that stage; stability = mean mIoU on PREVIOUS scenes at the final stage
    news, olds = [], []
    for i in range(a.scenes):
        row = matrix.get(f"stage_{i}", {})
        if scenes[i] in row:
            news.append(row[scenes[i]])
    last = matrix.get(f"stage_{a.scenes - 1}", {})
    for s in scenes[:-1]:
        if s in last:
            olds.append(last[s])
    out["new_scene_mIoU_mean"] = sum(news) / len(news) if news else None
    out["old_scene_final_mIoU_mean"] = (sum(olds) / len(olds)
                                        if olds else None)
    dst = os.path.join(env["results"], f"report_{arm}.json")
    with open(dst, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    print("[report] ->", dst)
    return out


def main(argv=None):
    a = parse_args(argv)
    if a.phase in ("pretrain", "stage", "all"):
        import torch
        from ..utils.device import resolve_device, set_deterministic
        resolve_device(a.device)
        torch.backends.cudnn.allow_tf32 = True
        set_deterministic()
    if a.phase in ("data", "all"):
        phase_data(a)
    if a.phase in ("pretrain", "all"):
        phase_pretrain(a)
    if a.phase == "stage":
        if a.stage_idx is None:
            raise ValueError("--phase stage needs --stage-idx")
        phase_stage(a, a.stage_idx)
    elif a.phase == "all":
        for i in range(a.scenes):
            phase_stage(a, i)
    if a.phase in ("report", "all"):
        phase_report(a)


if __name__ == "__main__":
    main()
    if "torch" in sys.modules:
        from ..parallel import shutdown
        shutdown()
