"""Segmentation fine-tuning on a NeRF-only stage's renders (counterpart of
the JAX package's train/finetune_loop.py; ref: scripts/
train_finetune.py:17-118 with finetune_data_module.py): validation on the
scene's last 20 % of frames with their ground truth (gtgt), training on
the renders and labels the stage `prev_exp_name` dumped for the first
80 % (data_module.train_image / train_label), optionally mixed with
ScanNet-25k replay (cl.active: the ScanNetCL mixer over split_file_cl's
train_cl frames cut to 25k_fraction); the phase order validate → 25k test
→ fit → validate → 25k test, then `deeplab_ckpt`.

The epoch is the pretrain loop's run_epoch; `last_ckpt` every epoch
holds the model, the optimizer and the epochs done, and a resume skips
the evaluations before the fit (they only log). Over several ranks (the
launcher's WORLD_SIZE) every rank reads the whole batch, the SegTrainer
shards it (run_epoch pads it to a multiple of the ranks), rank 0 writes
the checkpoints and logs, and the evaluations, a frame at a time as in
the JAX package, run whole on every rank.
"""

import os

import torch

from ..config.key_audit import audit_exp_keys
from ..data import DataLoader, ScanNet, ScanNetCL, ScanNetNGP, load_split
from ..metrics import SemanticsMeter
from ..models import DeepLabV3, seg_compute_dtype
from ..parallel.mesh import mesh_from_env
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer
from .checkpoints import load_deeplab, save_deeplab
from .experiment import on_rank0, seed_everything, setup_experiment
from .pretrain_loop import restore_state, run_epoch, save_state
from .seg_eval import build_test_25k, eval_25k
from .seg_trainer import SegTrainer


def _eval_per_scene(trainer, dataset, num_classes, logger, prefix):
    """Frames one at a time in eval mode, one meter a scene. Returns
    {scene: (mIoU, total accuracy, mean accuracy)}."""
    meters = {}
    for i in range(len(dataset)):
        img, label, _, scene = dataset[i]
        preds, _ = trainer.eval_step(torch.from_numpy(img)[None])
        meters.setdefault(scene, SemanticsMeter(num_classes)).update(
            preds[0], torch.as_tensor(label, device=preds.device))
    out = {}
    for scene, meter in meters.items():
        out[scene] = meter.measure()
        if logger is not None:
            logger.log({f"{prefix}/mean_IoU_{scene}": out[scene][0],
                        f"{prefix}/total_accuracy_{scene}": out[scene][1]})
    return out


def _eval_25k(trainer, dataset, num_classes, logger, tag):
    """The ScanNet-25k generalisation test before and after the fit (ref
    scripts/train_finetune.py:115-118), on seg_eval's batched loop."""
    miou, tacc, macc = eval_25k(
        lambda im: trainer.eval_step(torch.as_tensor(im))[0], dataset,
        num_classes)
    if logger is not None:
        logger.log({f"test/25k_mean_IoU_{tag}": miou,
                    f"test/25k_total_accuracy_{tag}": tacc,
                    f"test/25k_mean_accuracy_{tag}": macc})
    return miou, tacc, macc


def build_train_set(exp, env, output_size, prev_exp_name, seed):
    """(the train dataset, its collate): ScanNetNGP over the scenes' NeRF
    dumps, wrapped in the ScanNetCL replay mixer when cl.active."""
    cfg_dm = exp["data_module"]
    train_ds = ScanNetNGP(root=env["scannet"], mode="train",
                          train_image=cfg_dm.get("train_image", "nerf"),
                          train_label=cfg_dm.get("train_label", "nerf"),
                          scene_list=exp["scenes"],
                          prev_exp_name=prev_exp_name,
                          output_size=output_size, seed=seed)
    if not exp["cl"].get("active"):
        return train_ds, None
    split = load_split(os.path.join(
        env["scannet_frames_25k"],
        cfg_dm["data_preprocessing"]["split_file_cl"]))
    img_list_cl = split["train_cl"]
    img_list_cl = img_list_cl[:int(exp["cl"]["25k_fraction"]
                                   * len(img_list_cl))]
    scannet_25k = ScanNet(root=env["scannet_frames_25k"],
                          img_list=img_list_cl, mode="train",
                          output_size=output_size, seed=seed)
    return (ScanNetCL(scannet_25k, train_ds,
                      ngp_25k_ratio=exp["cl"]["ngp_25k_ratio"], seed=seed),
            ScanNetCL.collate)


def train(exp, env, args, exp_cfg_path=None, env_cfg_path=None,
          prev_exp_name="one_step_nerf_only", model=None):
    """A whole fine-tuning run on args.device (default "cuda"). args: seed,
    project_name, device. `model`: a DeepLabV3 to fine-tune (default R101
    drawn from --seed, computing in model.compute_dtype, then
    general.checkpoint_load when trainer.load_from_checkpoint). Returns the
    SegTrainer."""
    seed_everything(args.seed)
    audit_exp_keys(exp, "finetune")
    compute_dtype = seg_compute_dtype(exp.get("model"))
    device = resolve_device(getattr(args, "device", "cuda"))
    mesh = mesh_from_env(device)
    if mesh is not None:
        device = mesh.device
    model_path, logger = setup_experiment(
        exp, env, exp_cfg_path, env_cfg_path,
        getattr(args, "project_name", "finetune"), mesh)

    num_classes = exp["model"]["num_classes"]
    output_size = tuple(exp.get("output_size", (240, 320)))
    val_ds = ScanNetNGP(root=env["scannet"], mode="val", val_mode="gtgt",
                        scene_list=exp["scenes"], output_size=output_size)
    train_ds, collate = build_train_set(exp, env, output_size, prev_exp_name,
                                        args.seed)
    bs = exp["data_module"]["batch_size"]
    # shuffle and drop_last as the reference's finetune train loader hard
    # codes them (ref finetune_data_module.py:90-91); the data_module keys
    # are the pretrain loader's (ref pretrain_data_module.py:39-40)
    train_dl = DataLoader(train_ds, batch_size=bs, shuffle=True,
                          drop_last=True, collate_fn=collate, seed=args.seed)

    if model is None:
        model = DeepLabV3(num_classes=num_classes, device=device,
                          generator=torch.Generator().manual_seed(args.seed),
                          compute_dtype=compute_dtype)
    trainer = SegTrainer(model, exp["optimizer"], device=device, mesh=mesh)
    ckpt_load = exp["general"].get("checkpoint_load")
    trainer.init(load_deeplab(ckpt_load, map_location=device)
                 if exp.get("trainer", {}).get("load_from_checkpoint")
                 and ckpt_load else None)

    # per-epoch last_ckpt and resume (the reference's
    # ModelCheckpoint(save_last=True) + resume_from_checkpoint, ref
    # scripts/train_finetune.py:62-91); a string names the checkpoint
    last_dir = os.path.join(model_path, "last_ckpt")
    save_last = bool(exp.get("trainer", {}).get("save_last", True))
    start_epoch = 0
    resume = exp.get("trainer", {}).get("resume_from_checkpoint")
    if resume:
        rdir = resume if isinstance(resume, str) else last_dir
        if os.path.isdir(rdir):
            start_epoch = int(restore_state(rdir, trainer)["epoch"])
            print(f"[finetune] resumed from {rdir} at epoch {start_epoch}",
                  flush=True)
        else:
            print(f"[finetune] resume requested but no checkpoint at "
                  f"{rdir}; starting fresh", flush=True)

    profile = bool(exp.get("trainer", {}).get("profiler", False)) and (
        mesh is None or mesh.rank == 0)
    timer = StepTimer(os.path.join(model_path, "profile_steps.jsonl")
                      if profile else None)
    # validate → 25k test → fit → validate → 25k test (ref
    # train_finetune.py:115-118); the 25k test runs when its split file is
    # on disk
    test_25k = build_test_25k(exp, env, output_size)
    if start_epoch == 0:
        _eval_per_scene(trainer, val_ds, num_classes, logger, "val_pre")
        timer.tick("val_pre")
        if test_25k is not None:
            _eval_25k(trainer, test_25k, num_classes, logger, "pre")
            timer.tick("test_25k_pre")

    lr = float(exp["optimizer"]["lr"])
    meter = SemanticsMeter(num_classes)
    # with replay each batch holds ngp_25k_ratio 25k frames a scene frame
    eff_bs = bs * (1 + exp["cl"].get("ngp_25k_ratio", 0)) \
        if exp["cl"].get("active") else bs
    for epoch in range(start_epoch, exp["trainer"]["max_epochs"]):
        meter.clear()
        run_epoch(trainer, train_dl, eff_bs, lr, meter, logger, "train",
                  train=True, epoch=epoch, seed=args.seed)
        miou, tacc, _ = meter.measure()
        logger.log({"train/mean_IoU": miou, "train/total_accuracy": tacc},
                   step=epoch)
        timer.tick("train_epoch", epoch=epoch)
        if save_last:
            on_rank0(mesh, save_state, last_dir, trainer, epoch + 1)
            timer.tick("last_ckpt", epoch=epoch)

    _eval_per_scene(trainer, val_ds, num_classes, logger, "val")
    timer.tick("val")
    if test_25k is not None:
        _eval_25k(trainer, test_25k, num_classes, logger, "post")
        timer.tick("test_25k_post")
    on_rank0(mesh, save_deeplab, os.path.join(model_path, "deeplab_ckpt"),
             trainer.model.state_dict())
    timer.tick("deeplab_ckpt")
    timer.close()
    logger.close()
    return trainer
