"""One adaptation stage: NeRF fit → joint training → predict dumps
(counterpart of the JAX package's train/joint_loop.py; ref:
scripts/train_joint.py:47-186 and the Lightning epoch plumbing around
`JointTrainLightningNet`):
  phase order = NeRF-only fit (nerf_train_epoch epochs) → NeRF test on the
  train split → seg validation → joint fit (joint_train_epoch epochs, val
  every check_val_every_n_epoch, a predict dump every 10) → NeRF test →
  ScanNet-25k test (when its split is on disk) → predict (pseudo-label /
  replay PNG dumps) → save `deeplab_ckpt` for the next stage and
  `nerf_ckpt`. With `cl.active: true` every joint batch also carries
  `ngp_25k_ratio` ScanNet-25k replay frames a scene item (the
  ScanNetCLJoint mixer over `split_file_cl`'s train_cl list, cut to
  `25k_fraction`); train/cl_driver.py chains stages.

The JointTrainer holds both models and optimizers and updates them in
place; one torch.Generator on the trainer's device, seeded with --seed,
stands in for the JAX package's threaded key, and its state goes into the
per-epoch `last_ckpt` with both models, both optimizers, the occupancy
grid (none under nerf.use_occupancy: false) and the counters, so that a
resumed run continues the interrupted one.

Data parallelism (JAX `joint_loop.py:450-452`): with more than one rank
(the launcher's WORLD_SIZE, or a process group already up) the
JointTrainer gets a parallel.Mesh unless trainer_kwargs name one. Every
rank reads the same batches and seeds its generator alike; the trainer
shards the work. Rank 0 writes the checkpoints (behind a barrier), the
predict dumps, the plots and the logs; every rank loads a resume onto its
own device (JAX restores onto device 0 and re-replicates, `:158`).
"""

import os
import shutil
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields

import numpy as np
import torch

from ..config import SHIPPED_NERF_ENC, SHIPPED_NERF_SFWD
from ..config.key_audit import audit_exp_keys
from ..data import (DataLoader, ScanNet, ScanNetCLJoint, ScanNetNGPJoint,
                    load_split)
from ..data.image_io import write_png
from ..metrics import SemanticsMeter
from ..models import DeepLabV3, SemanticNeRF, seg_compute_dtype
from ..ops.renderer import RenderConfig
from ..parallel.mesh import mesh_from_env
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer
from ..viz import Visualizer
from ..viz.colormaps import NYU40_COLOUR_CODE
from .checkpoints import load_deeplab, load_tree, save_deeplab, save_tree
from .experiment import on_rank0, seed_everything, setup_experiment
from .joint_trainer import JointTrainer
from .seg_eval import build_test_25k, eval_25k

PREDICT_SUBFOLDERS = ("nerf_image", "nerf_label", "nerf_label_vis",
                      "seg_label", "seg_label_vis")

# renderer keys of the JAX package's RenderConfig that the port's lacks:
# accepted and dropped, since they change only memory (remat)
_RENDER_IGNORED = ("remat",)


def render_cfgs_from_exp(exp):
    """(train RenderConfig, test RenderConfig | None, predict RenderConfig
    | None) from the optional `renderer:` block of an experiment YAML, as
    the JAX package resolves it: any RenderConfig field passes through
    (quoted numbers cast by the field's type), `test_`-prefixed keys
    configure the full-frame test and predict renders, `predict_`-prefixed
    keys the predict dump on top of the test config, test_num_steps
    without test_upsample_steps implies a symmetric budget (the same for
    predict_), and the defaults are the reference's 256 + 256. Keys the
    JAX package's RenderConfig has and the port's lacks are dropped
    (_RENDER_IGNORED)."""
    r = dict(exp.get("renderer", {}))
    types = {f.name: f.type for f in fields(RenderConfig)}
    known = set(types) | set(_RENDER_IGNORED)

    def field(k):
        """The RenderConfig field a key names, or None."""
        if k in known:
            return k
        for p in ("test_", "predict_"):
            if k.startswith(p) and k[len(p):] in known:
                return k[len(p):]
        return None

    unknown = [k for k in r if field(k) is None]
    if unknown:
        warnings.warn(f"renderer config keys not recognized: {unknown} "
                      f"(known: sorted RenderConfig fields, optionally "
                      f"test_- or predict_-prefixed)")

    def coerce(k, v):
        # a quoted number ("256") becomes the field's int or float; bools
        # pass through (bool("false") would be True)
        t = {"int": int, "float": float, int: int, float: float}.get(
            types.get(k))
        return t(v) if t is not None and not isinstance(v, bool) else v

    def prefixed(prefix):
        return {k[len(prefix):]: coerce(k[len(prefix):], v)
                for k, v in r.items()
                if k.startswith(prefix) and k[len(prefix):] in known}

    def make(d):
        return RenderConfig(**{k: v for k, v in d.items() if k in types})

    base = {k: coerce(k, v) for k, v in r.items() if k in known}
    base.setdefault("num_steps", 256)
    base.setdefault("upsample_steps", 256)
    test = prefixed("test_")
    test_cfg = None
    if test:
        test.setdefault("upsample_steps",
                        test.get("num_steps", base["upsample_steps"]))
        test_cfg = make({**base, **test})
    predict = prefixed("predict_")
    predict_cfg = None
    if predict:
        predict.setdefault("upsample_steps",
                           predict.get("num_steps",
                                       (test or base)["upsample_steps"]))
        predict_cfg = make({**base, **test, **predict})
    return make(base), test_cfg, predict_cfg


def nerf_model_from_exp(exp, num_classes, device="cuda", generator=None):
    """SemanticNeRF from the optional `nerf:` YAML block, on `device`, its
    init drawn from `generator` (a CPU torch.Generator). The defaults follow
    the shipped configuration (config/shipped.py); the consumed keys are
    config/key_audit.py's _ENTRY_CONSUMED['joint']; a stochastic_fwd value
    other than false, true, 'fine' or 'face' raises."""
    n = exp.get("nerf", {})
    sfwd = n.get("stochastic_fwd", SHIPPED_NERF_SFWD)
    if sfwd not in (False, True, "fine", "face"):
        raise ValueError(
            f"nerf.stochastic_fwd={sfwd!r}: expected false, true, "
            f"'fine', or 'face' (models/semantic_nerf.py)")
    return SemanticNeRF(
        bound=float(n.get("bound", 4.0)),
        num_semantic_classes=num_classes,
        n_levels=int(n.get("n_levels", SHIPPED_NERF_ENC[0])),
        n_features=int(n.get("n_features", SHIPPED_NERF_ENC[1])),
        log2_hashmap_size=int(n.get("log2_hashmap_size", 19)),
        stochastic_table_grad=bool(n.get("stochastic_table_grad", True)),
        stochastic_fwd=sfwd, device=device, generator=generator)


def _stage_state_tree(done, trainer, occ_grid, generator, occ_step):
    """The full mid-stage training state as one checkpoint tree: both
    models and both optimizers (JointTrainer.state_dict, the slab counter
    included), the occupancy grid, the loop generator's state and the
    counters (the reference's Lightning ModelCheckpoint(save_last=True)
    every epoch, ref scripts/train_joint.py:90-94). Loader shuffles are
    pure functions of (seed, epoch), so restoring this tree and pinning
    the loader epoch continues the interrupted trajectory."""
    tree = {"done": int(done), "occ_step": int(occ_step),
            "generator": generator.get_state(), **trainer.state_dict()}
    if occ_grid is not None:
        tree["occ_grid"] = occ_grid
    return tree


def _save_stage_state(path, *args):
    save_tree(path, _stage_state_tree(*args))


def _restore_stage_state(path, trainer, occ_grid, generator):
    """Load a `last_ckpt` written by `_save_stage_state` onto the trainer's
    device, into the trainer and the generator. Returns (done, occ_grid,
    occ_step)."""
    tree = load_tree(path, map_location=trainer.device)
    trainer.load_state_dict(tree)
    generator.set_state(tree["generator"].cpu())
    if occ_grid is not None:
        occ_grid = tree["occ_grid"]
    return int(tree["done"]), occ_grid, int(tree["occ_step"])


def _resident_fit_buffers(trainer, dataset):
    """Phase-1 buffers on the device: every train_nerf item read and decoded
    once (mode "train" with only_new_scene never takes the augmentation
    branch, so the items are the same every epoch), stacked, copied once,
    and pseudo-labelled once (the seg net is frozen during phase 1)."""
    items = [dataset[i] for i in range(len(dataset))]
    bufs = {k: torch.as_tensor(np.stack([it[k] for it in items]),
                               dtype=torch.float32, device=trainer.device)
            for k in ("img", "depth", "pose", "intrinsics",
                      "one_m_to_scene_uom")}
    bufs["pseudo"] = trainer.seg_pseudo_labels(bufs["img"])
    return bufs


def build_datamodule(exp, env, output_size, val_scene_list=None, seed=0):
    """The datasets of the reference's JointTrainDataModule (ref:
    nr4seg/lightning/joint_train_data_module.py:30-117): val, train_val,
    predict, train_nerf, train_joint and test_25k. `seed` seeds the
    train-mode datasets' augmentation streams and the 25k replay draw; the
    old-scene frames' shuffle stays random.Random(0), as in the reference.
    With cl.active, train_joint is the ScanNetCLJoint mixer over the scene
    dataset and the first 25k_fraction of split_file_cl's train_cl
    frames."""
    scenes = exp["scenes"]
    exp_name = exp["exp_name"]
    root = env["scannet"]
    novel = exp["cl"].get("use_novel_viewpoints", False)
    dm = {}
    for mode in ("val", "train_val"):
        dm[mode] = ScanNetNGPJoint(root=root, mode=mode, scene_list=scenes,
                                   exp_name=exp_name, only_new_scene=False,
                                   output_size=output_size,
                                   val_scene_list=val_scene_list)
    dm["predict"] = ScanNetNGPJoint(
        root=root, mode="predict", scene_list=scenes, exp_name=exp_name,
        use_novel_viewpoints=novel, only_new_scene=True,
        output_size=output_size)
    dm["train_nerf"] = ScanNetNGPJoint(root=root, mode="train",
                                       scene_list=scenes, exp_name=exp_name,
                                       only_new_scene=True,
                                       output_size=output_size, seed=seed)
    train_joint = ScanNetNGPJoint(
        root=root, mode="train", scene_list=scenes, exp_name=exp_name,
        only_new_scene=False, seed=seed, use_novel_viewpoints=novel,
        # False as in the reference's data module (ref
        # joint_train_data_module.py:85): --fix_nerf gates only the NeRF
        # update in the trainer
        fix_nerf=False,
        replay_buffer_size=exp["cl"].get("replay_buffer_size"),
        output_size=output_size)
    if exp["cl"].get("active"):
        split = load_split(os.path.join(
            env["scannet_frames_25k"],
            exp["data_module"]["data_preprocessing"]["split_file_cl"]))
        img_list_cl = split["train_cl"]
        img_list_cl = img_list_cl[:int(exp["cl"]["25k_fraction"]
                                       * len(img_list_cl))]
        scannet_25k = ScanNet(root=env["scannet_frames_25k"],
                              img_list=img_list_cl, mode="train",
                              output_size=output_size, seed=seed)
        train_joint = ScanNetCLJoint(scannet_25k, train_joint,
                                     ngp_25k_ratio=exp["cl"]["ngp_25k_ratio"],
                                     seed=seed)
    dm["train_joint"] = train_joint
    dm["test_25k"] = build_test_25k(exp, env, output_size)
    return dm


def validate_seg(trainer, dataset, meter_factory, logger, prefix,
                 visualizer=None, visu_n=0):
    """Per-scene seg validation (ref validation_step :541-639): frames one
    at a time, grouped by scene, one meter per scene; the first visu_n
    frames plotted (ref visu :304-341). Returns {scene: (mIoU, total
    accuracy, mean accuracy)}."""
    results = {}
    meter = meter_factory()
    prev_scene = None
    for i in range(len(dataset)):
        item = dataset[i]
        scene = item["current_scene_name"]
        if prev_scene is not None and scene != prev_scene:
            results[prev_scene] = meter.measure()
            meter = meter_factory()
        prev_scene = scene
        pred, _ = trainer.seg_infer(item["img"][None])
        meter.update(pred[0], torch.as_tensor(item["label"],
                                              device=pred.device))
        if visualizer is not None and i < visu_n:
            visualizer.plot_image(item["img"],
                                  tag=f"{prefix}_vis/gt_image_{i}")
            visualizer.plot_segmentation(
                pred[0].cpu().numpy() + 1, tag=f"{prefix}_vis/pred_seg_{i}")
            visualizer.plot_segmentation(
                item["label"] + 1, tag=f"{prefix}_vis/target_{i}")
            visualizer.plot_detectron(item["img"], item["label"] + 1,
                                      tag=f"{prefix}_vis/detectron_{i}")
    if prev_scene is not None:
        results[prev_scene] = meter.measure()
    if logger is not None:
        for scene, (miou, tacc, macc) in results.items():
            logger.log({f"{prefix}/seg_mean_IoU_{scene}": miou,
                        f"{prefix}/seg_total_accuracy_{scene}": tacc,
                        f"{prefix}/seg_mean_accuracy_{scene}": macc})
    return results


def test_nerf(trainer, dataset, num_classes, logger, prefix, occ_grid=None,
              group=4, visualizer=None, visu_n=0):
    """NeRF label quality on the train frames (ref test_step :648-660),
    `group` frames a staged render at the test budget; the first `visu_n`
    frames plot the image, the render, the rendered labels, the target and
    the detectron overlay (ref test_step visu :654-660). Returns (mIoU,
    total accuracy, mean accuracy)."""
    meter = SemanticsMeter(num_classes)
    n = len(dataset)
    for s in range(0, n, group):
        items = [dataset[i] for i in range(s, min(s + group, n))]
        outs = trainer.render_frames(np.stack([it["pose"] for it in items]),
                                     items[0]["intrinsics"], occ_grid,
                                     group=group)
        labels = torch.as_tensor(np.stack([it["label"] for it in items]),
                                 device=trainer.device)
        meter.update(outs["nerf_semantics"], labels)
        if visualizer is not None:
            for j, item in enumerate(items):
                c = s + j
                if c >= visu_n:
                    break
                visualizer.plot_image(item["img"],
                                      tag=f"{prefix}_vis/gt_image_{c}")
                visualizer.plot_image(outs["nerf_rgb"][j].cpu().numpy(),
                                      tag=f"{prefix}_vis/nerf_image_{c}")
                visualizer.plot_segmentation(
                    outs["nerf_semantics"][j].cpu().numpy() + 1,
                    tag=f"{prefix}_vis/pred_nerf_{c}")
                visualizer.plot_segmentation(
                    item["label"] + 1, tag=f"{prefix}_vis/target_{c}")
                visualizer.plot_detectron(item["img"], item["label"] + 1,
                                          tag=f"{prefix}_vis/detectron_{c}")
    miou, tacc, macc = meter.measure()
    if logger is not None:
        logger.log({f"{prefix}/nerf_mean_IoU": miou,
                    f"{prefix}/nerf_total_accuracy": tacc,
                    f"{prefix}/nerf_mean_accuracy": macc})
    return miou, tacc, macc


def make_predict_dirs(root_folder):
    """(ref on_predict_epoch_start :695-712)"""
    for sub in ("", "novel_viewpoints"):
        for name in PREDICT_SUBFOLDERS:
            p = os.path.join(root_folder, sub, name)
            if os.path.exists(p):
                shutil.rmtree(p)
            os.makedirs(p)


def write_predict_outputs(root_folder, item, out):
    """PNG dumps of one predict frame (ref predict_step :722-782); `out`
    holds numpy nerf_rgb [H, W, 3], nerf_semantics and seg_semantics [H,
    W]. Labels are stored +1 (0 = unknown), as uint8."""
    sub = "novel_viewpoints" if item["viewpoint_is_novel"] else ""
    path = lambda name: os.path.join(root_folder, sub, name,
                                     item["current_index"] + ".png")
    rgb = (np.clip(out["nerf_rgb"], 0, 1) * 255).astype(np.uint8)
    write_png(path("nerf_image"), rgb)
    for name, key in (("nerf_label", "nerf_semantics"),
                      ("seg_label", "seg_semantics")):
        label = np.asarray(out[key]).astype(np.int64) + 1
        write_png(path(name), label.astype(np.uint8))
        write_png(path(name + "_vis"), NYU40_COLOUR_CODE[label])


def run_predict(trainer, dataset, root_folder, occ_grid=None, group=4,
                write=True):
    """Predict dump (ref predict_step :714-782), `group` frames a staged
    render at the predict budget and one seg forward (of the frame's
    image, or of the render for a novel viewpoint). The PNG encodes (five
    files a frame; zlib releases the GIL) run on a thread pool, so they
    overlap the next group's render; at most ~32 frames are in flight and
    a worker's exception is raised here. write=False renders without
    writing (the ranks but rank 0 under a mesh)."""
    if write:
        make_predict_dirs(root_folder)
    n = len(dataset)
    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = deque()
        for s in range(0, n, group):
            items = [dataset[i] for i in range(s, min(s + group, n))]
            outs = trainer.render_frames(
                np.stack([it["pose"] for it in items]),
                items[0]["intrinsics"], occ_grid, group=group,
                which="predict")
            novel = [bool(it["viewpoint_is_novel"]) for it in items]
            seg_in = torch.as_tensor(np.stack([
                np.zeros((trainer.H, trainer.W, 3), np.float32) if nv
                else it["img"] for it, nv in zip(items, novel)]),
                device=trainer.device)
            seg_in = torch.where(
                torch.tensor(novel, device=trainer.device)[:, None, None,
                                                           None],
                outs["nerf_rgb"], seg_in)
            seg_pred = trainer.seg_infer(seg_in)[0].cpu().numpy()
            host = {k: outs[k].cpu().numpy()
                    for k in ("nerf_rgb", "nerf_semantics")}
            for j, item in enumerate(items):
                if not write:
                    break
                out = {k: v[j] for k, v in host.items()}
                out["seg_semantics"] = seg_pred[j]
                pending.append(pool.submit(write_predict_outputs,
                                           root_folder, item, out))
            while len(pending) > 32:
                pending.popleft().result()
        while pending:
            pending.popleft().result()


def train(exp, env, args, exp_cfg_path=None, env_cfg_path=None,
          render_cfg: RenderConfig | None = None, val_scene_list=None,
          trainer_kwargs: dict | None = None):
    """One whole stage (ref scripts/train_joint.py:47-186) on
    args.device (default "cuda"). args: seed, exp_name, fix_nerf,
    nerf_train_epoch, joint_train_epoch, project_name, device.
    trainer_kwargs go to JointTrainer (n_rays, nerf_model, seg_model, test
    and predict configs); without models, the NeRF comes from the `nerf:`
    block and the seg net is DeepLabV3-R101, each drawn from --seed.
    Returns (the JointTrainer, the occupancy grid) at the end of the
    stage."""
    seed_everything(args.seed)
    exp["exp_name"] = args.exp_name
    exp["fix_nerf"] = getattr(args, "fix_nerf", False)
    audit_exp_keys(exp, "joint")
    device = resolve_device(getattr(args, "device", "cuda"))
    trainer_kwargs = dict(trainer_kwargs or {})
    if "mesh" not in trainer_kwargs:
        trainer_kwargs["mesh"] = mesh_from_env(device)
    mesh = trainer_kwargs["mesh"]
    if mesh is not None:
        device = mesh.device
    rank0 = mesh is None or mesh.rank == 0
    model_path, logger = setup_experiment(exp, env, exp_cfg_path, env_cfg_path,
                                          getattr(args, "project_name",
                                                  "joint"), mesh)

    # val scene set: the reference hardcodes scenes 0000-0009
    # (scannet_ngp_joint.py:66-93); exp["val_scenes"] overrides it
    val_scene_list = val_scene_list or exp.get("val_scenes")
    output_size = tuple(exp.get("output_size", (240, 320)))
    num_classes = exp["model"]["num_classes"]
    test_render_cfg = predict_render_cfg = None
    if render_cfg is None and "renderer" in exp:
        render_cfg, test_render_cfg, predict_render_cfg = \
            render_cfgs_from_exp(exp)
    if test_render_cfg is not None:
        trainer_kwargs.setdefault("test_render_cfg", test_render_cfg)
    if predict_render_cfg is not None:
        trainer_kwargs.setdefault("predict_render_cfg", predict_render_cfg)
    seeded = lambda k: torch.Generator().manual_seed(args.seed + k)
    if "nerf_model" not in trainer_kwargs:
        trainer_kwargs["nerf_model"] = (
            nerf_model_from_exp(exp, num_classes, device, seeded(0))
            if "nerf" in exp else
            SemanticNeRF(bound=4.0, num_semantic_classes=num_classes,
                         device=device, generator=seeded(0)))
        if "n_rays" in exp.get("nerf", {}):
            trainer_kwargs.setdefault("n_rays", int(exp["nerf"]["n_rays"]))
    if "seg_model" not in trainer_kwargs:
        trainer_kwargs["seg_model"] = DeepLabV3(
            num_classes=num_classes, device=device, generator=seeded(1),
            compute_dtype=seg_compute_dtype(exp.get("model")))
    trainer = JointTrainer(exp, image_hw=output_size, num_classes=num_classes,
                           render_cfg=render_cfg, device=device,
                           **trainer_kwargs)
    # the active render budgets at stage start: the derived test / predict
    # budgets differ from the train budget, and a quality regression on a
    # new scene must be traceable to them
    if rank0:
        print(f"[joint] render budgets: {trainer.budget_summary()}",
              flush=True)
    logger.log_hyperparams({"render_budgets": trainer.budget_summary()})
    generator = torch.Generator(device=device).manual_seed(args.seed)

    # checkpoint load with aux-head surgery (ref :111-132)
    seg_state = None
    if exp.get("trainer", {}).get("load_from_checkpoint") and \
            exp["general"].get("checkpoint_load"):
        seg_state = load_deeplab(exp["general"]["checkpoint_load"],
                                 map_location=device)
    trainer.init(None, seg_state)
    occ_grid = trainer.init_occupancy()
    occ_step = 0

    # --- per-epoch last checkpoint + mid-stage resume (the reference's
    # Lightning ModelCheckpoint(save_last=True) + trainer
    # resume_from_checkpoint, ref scripts/train_joint.py:90-109). `done`
    # counts completed epochs linearly across both phases; a truthy
    # `trainer.resume_from_checkpoint` restores from `<run>/last_ckpt` (or
    # an explicit checkpoint dir path) and skips the finished epochs ---
    last_dir = os.path.join(model_path, "last_ckpt")
    save_last = bool(exp.get("trainer", {}).get("save_last", True))
    start_done = 0
    resume = exp.get("trainer", {}).get("resume_from_checkpoint")
    if resume:
        rdir = resume if isinstance(resume, str) else last_dir
        if os.path.isdir(rdir):
            start_done, occ_grid, occ_step = _restore_stage_state(
                rdir, trainer, occ_grid, generator)
            print(f"[joint] resumed from {rdir}: "
                  f"{start_done}/{args.nerf_train_epoch}"
                  f"+{args.joint_train_epoch} epochs done", flush=True)
        else:
            print(f"[joint] resume requested but no checkpoint at {rdir}; "
                  f"starting fresh", flush=True)

    def save_last_ckpt(done):
        if save_last:
            on_rank0(mesh, _save_stage_state, last_dir, done, trainer,
                     occ_grid, generator, occ_step)

    dm = build_datamodule(exp, env, output_size, val_scene_list,
                          seed=args.seed)
    bs = exp["data_module"]["batch_size"]
    viz_cfg = exp.get("visualizer", {})
    visualizer = Visualizer(os.path.join(model_path, "visu"),
                            store=viz_cfg.get("store", False) and rank0)
    # every plot also goes to the experiment logger, like the reference's
    # wandb image logging (ref visualizer.py:60-81)
    visualizer.set_logger(logger.log_image)
    # store_n budgets per split (ref visualizer.store_n.{train,val,test})
    store_n = viz_cfg.get("store_n", {}) \
        if viz_cfg.get("store", False) and rank0 else {}
    visu_n = store_n.get("val", 0)
    visu_train = store_n.get("train", 0)
    visu_test = store_n.get("test", 0)
    # validation cadence (ref Trainer(**exp["trainer"]) honours
    # check_val_every_n_epoch); the predict dump every 10 joint epochs is
    # the reference's hardcoded manual cadence (ref :344-355)
    check_val_every = max(1, int(exp.get("trainer", {}).get(
        "check_val_every_n_epoch", 1)))

    profile = bool(exp.get("trainer", {}).get("profiler", False)) and rank0
    timer = StepTimer(os.path.join(model_path, "profile_steps.jsonl")
                      if profile else None)
    meter = lambda: SemanticsMeter(num_classes)
    nerf_cfg = exp.get("nerf", {})

    # --- phase 1: NeRF-only fit (bs=1 loader order, ref :119-127,163-165).
    # Default: the epoch runs over device-resident buffers
    # (JointTrainer.nerf_fit_epoch) with the loader's shuffle; the step
    # loop over the loader stays for datasets too large to keep on the
    # device and as the `nerf.scan_epoch_fit: false` switch ---
    scan_fit = (bool(nerf_cfg.get("scan_epoch_fit", True))
                and args.nerf_train_epoch > start_done
                and 0 < len(dm["train_nerf"])
                <= int(nerf_cfg.get("scan_fit_max_images", 512)))
    if scan_fit:
        fit_bufs = _resident_fit_buffers(trainer, dm["train_nerf"])
    for epoch in range(args.nerf_train_epoch):
        if epoch < start_done:
            continue
        if scan_fit:
            # the DataLoader's shuffle: rng(seed + epoch) over arange(n)
            order = np.arange(len(dm["train_nerf"]))
            np.random.default_rng(args.seed + epoch).shuffle(order)
            occ_grid, occ_step, parts = trainer.nerf_fit_epoch(
                fit_bufs, order, generator, occ_step, occ_grid)
            logger.log({f"train/{n}": float(v) for n, v in parts.items()},
                       step=epoch)
        else:
            nerf_dl = DataLoader(dm["train_nerf"], batch_size=1,
                                 shuffle=True, seed=args.seed)
            nerf_dl.set_epoch(epoch)
            epoch_logs, n_batches = {}, 0
            for batch in nerf_dl:
                logs = trainer.nerf_fit_step(batch, generator, occ_grid)
                n_batches += 1
                for n, v in logs.items():
                    epoch_logs[n] = epoch_logs.get(n, 0.0) + v
                occ_step += 1
                if occ_grid is not None and \
                        occ_step % trainer.nerf.occ_cfg.update_every == 0:
                    occ_grid = trainer.update_occupancy(occ_grid, generator)
            if n_batches:
                logger.log({f"train/{n}": float(v) / n_batches
                            for n, v in epoch_logs.items()}, step=epoch)
        timer.tick("nerf_epoch", epoch=epoch)
        save_last_ckpt(epoch + 1)

    # initial nerf quality + seg validation (ref :167-169); skipped when a
    # resume lands past them (they only log)
    if start_done <= args.nerf_train_epoch:
        test_nerf(trainer, dm["train_nerf"], num_classes, logger,
                  "test_pre", occ_grid, visualizer=visualizer,
                  visu_n=visu_test)
        timer.tick("test_pre")
        validate_seg(trainer, dm["val"], meter, logger, "val_pre",
                     visualizer, visu_n)
        timer.tick("val_pre")

    # --- phase 2: joint training (ref :171-177) ---
    joint_dl = DataLoader(dm["train_joint"], batch_size=bs, shuffle=True,
                          drop_last=True, collate_fn=ScanNetNGPJoint.collate,
                          seed=args.seed)
    scene_root = os.path.join(env["scannet"], exp["scenes"][-1],
                              exp["exp_name"])
    for epoch in range(args.joint_train_epoch):
        if args.nerf_train_epoch + epoch < start_done:
            continue
        joint_dl.set_epoch(epoch)
        epoch_logs, n_batches = {}, 0
        for batch_old, batch_new, batch_cl in joint_dl:
            logs = trainer.joint_step(batch_old, batch_new, batch_cl,
                                      generator, occ_grid)
            n_batches += 1
            for n, v in logs.items():
                epoch_logs[n] = epoch_logs.get(n, 0.0) + v
            occ_step += 1
            if occ_grid is not None and not exp.get("fix_nerf") and \
                    occ_step % trainer.nerf.occ_cfg.update_every == 0:
                occ_grid = trainer.update_occupancy(occ_grid, generator)
        if n_batches:
            logger.log({f"train/{n}": float(v) / n_batches
                        for n, v in epoch_logs.items()},
                       step=args.nerf_train_epoch + epoch)
        timer.tick("joint_epoch", epoch=epoch)
        save_last_ckpt(args.nerf_train_epoch + epoch + 1)
        if (epoch + 1) % check_val_every == 0:
            validate_seg(trainer, dm["val"], meter, logger,
                         f"val_e{epoch + 1}", visualizer, visu_n)
            validate_seg(trainer, dm["train_val"], meter, logger,
                         f"train_val_e{epoch + 1}", visualizer, visu_train)
            timer.tick("joint_val", epoch=epoch)
        if (epoch + 1) % 10 == 0:
            # mid-training predict dump (ref :344-355,784-874)
            run_predict(trainer, dm["predict"],
                        f"{scene_root}_epoch_{epoch + 1}", occ_grid,
                        write=rank0)
            timer.tick("predict_mid", epoch=epoch)

    # --- final tests + predict + checkpoints (ref :179-186) ---
    test_nerf(trainer, dm["train_nerf"], num_classes, logger, "test",
              occ_grid, visualizer=visualizer, visu_n=visu_test)
    timer.tick("test_final")
    if dm["test_25k"] is not None:
        miou, tacc, macc = eval_25k(lambda im: trainer.seg_infer(im)[0],
                                    dm["test_25k"], num_classes)
        logger.log({"test/25k_mean_IoU": miou,
                    "test/25k_total_accuracy": tacc,
                    "test/25k_mean_accuracy": macc})
        timer.tick("test_25k")
    run_predict(trainer, dm["predict"], scene_root, occ_grid, write=rank0)
    if mesh is not None:
        mesh.barrier()
    timer.tick("predict_final")
    # the per-scene NeRF with its occupancy grid, which a re-render of the
    # replay views needs (the JAX package's nerf_ckpt holds the params)
    def save_final():
        save_deeplab(os.path.join(model_path, "deeplab_ckpt"),
                     trainer.seg.model.state_dict())
        save_tree(os.path.join(model_path, "nerf_ckpt"),
                  {"params": trainer.nerf.model.state_dict(),
                   "occ_grid": occ_grid})
    on_rank0(mesh, save_final)
    timer.close()
    logger.close()
    return trainer, occ_grid
