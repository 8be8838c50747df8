"""DeepLabV3 pretraining on ScanNet-25k (counterpart of the JAX package's
train/pretrain_loop.py; ref: scripts/pretrain.py:17-114 with
semantics_lightning_net.py and pretrain_data_module.py): the train / val
/ test `ScanNet` sets of the split file, POLY learning rate by epoch, the
best checkpoint by val mean IoU, `last_ckpt` every epoch and resume, the
test pass at the end.

The SegTrainer updates its model and optimizer in place. A short last
batch is padded to the batch size with copies of its own images (JAX's
static shapes), which enter BatchNorm's batch statistics as in the JAX
package, while their −1 labels keep them out of the loss (divided by the
real images' pixels) and the confusion matrix.

Data parallelism (JAX `pretrain_loop.py:20-60, 111-114`, where a mesh
replaces Lightning DDP): with more than one rank (the launcher's
WORLD_SIZE, or a process group already up) the loop runs on a
parallel.Mesh. Every batch is padded to ceil(batch_size / ranks)·ranks
rows, and each rank reads only its block of it (split loading,
DataLoader.shard: the shuffle stays default_rng(seed + epoch), so the
decode splits across the ranks); the SegTrainer syncs BatchNorm and sums
the gradients, the meters sum the confusion matrices, rank 0 writes the
checkpoints (behind a barrier) and logs, and every rank loads a resume.

A step's dropout draws from a generator on the trainer's device seeded by
a pure function of (seed, epoch, step) and the loader's shuffle is a
function of (seed, epoch), so a resumed run replays the uninterrupted
one.
"""

import os
import warnings

import numpy as np
import torch

from ..config.key_audit import audit_exp_keys
from ..data import DataLoader, ScanNet, load_split
from ..metrics import SemanticsMeter
from ..models import DeepLabV3, seg_compute_dtype
from ..parallel.mesh import mesh_from_env
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer, maybe_trace
from .checkpoints import load_deeplab, load_tree, save_deeplab, save_tree
from .experiment import on_rank0, seed_everything, setup_experiment
from .seg_trainer import SegTrainer, poly_lr_factor


def _pad_to(batch, size):
    """(img, label) padded along the batch to `size`: the pad repeats the
    batch's real images (wraparound), whose BatchNorm statistics stay in
    distribution, with labels of −1. Returns (img, label, n_real)."""
    img, label = batch
    n = img.shape[0]
    if n == size:
        return img, label, n
    reps = np.arange(size - n) % n
    img = np.concatenate([img, img[reps]], 0)
    label = np.concatenate(
        [label, np.full((size - n, *label.shape[1:]), -1, label.dtype)], 0)
    return img, label, n


def dropout_generator(seed: int, epoch: int, step: int, device):
    """The dropout generator of one step, on `device`: its seed a pure
    function of (seed, epoch, step) (the JAX package folds the same triple
    into a key)."""
    words = np.random.SeedSequence([seed, epoch, step]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 32) | int(words[1]))


def epoch_lr(exp: dict, epoch: int) -> float:
    """The epoch's learning rate: POLY when lr_scheduler is active and
    named so, else optimizer.lr."""
    init_lr = float(exp["optimizer"]["lr"])
    sched = exp.get("lr_scheduler", {})
    if sched.get("active") and sched.get("name") == "POLY":
        p = sched["poly_cfg"]
        return poly_lr_factor(epoch, p["max_epochs"], p["power"], init_lr,
                              float(p["target_lr"]))
    return init_lr


def run_epoch(trainer, loader, batch_size, lr, meter, logger, mode,
              train=True, epoch=0, seed=0):
    """One pass over `loader`, every batch padded to batch_size. Training:
    the loader pinned to `epoch`, a step a batch at `lr` with the step's
    dropout generator, its confusion matrix into `meter`, the epoch's mean
    loss logged as `<mode>/loss`. Otherwise: eval-mode predictions into
    `meter`.

    Under the trainer's mesh every batch is padded to a multiple of the
    ranks (module docstring). A split loader (DataLoader.shard) gives this
    rank's block, whose padding rows take −1 labels here; a whole batch is
    blocked by the trainer in a step, and by this rank's block here in an
    evaluation, whose meter then sums over the ranks (SemanticsMeter's
    mesh)."""
    losses = []
    mesh = trainer.mesh
    ranks = 1 if mesh is None else mesh.size
    target = -(-batch_size // ranks) * ranks
    if train:
        loader.set_epoch(epoch)
    for i, batch in enumerate(loader):
        sharded = mesh is not None and loader.sharded
        if sharded:
            (img, label, *_), pad, n_real = batch
            label = label.copy()
            label[pad] = -1
        else:
            img, label, n_real = _pad_to((batch[0], batch[1]), target)
            if mesh is not None and not train:
                sl = mesh.block(target)
                img, label = img[sl], label[sl]
        img, label = torch.from_numpy(img), torch.from_numpy(label)
        if train:
            loss, conf = trainer.train_step(
                img, label, lr,
                dropout_generator(seed, epoch, i, trainer.device),
                n_real=n_real, sharded=sharded)
            losses.append(loss)
            meter.update_confmat(conf)
        else:
            preds, _ = trainer.eval_step(img)
            meter.update(preds, label.to(preds.device))
    if losses and logger is not None:
        logger.log({f"{mode}/loss":
                    float(torch.stack(losses).double().mean())})


def warn_pretrained_backbone(exp: dict):
    """model.pretrained_backbone asks for ImageNet weights, which the port
    does not download: warn, unless a checkpoint is loaded instead."""
    if exp.get("model", {}).get("pretrained_backbone") and not (
            exp.get("trainer", {}).get("load_from_checkpoint")
            and exp["general"].get("checkpoint_load")):
        warnings.warn(
            "model.pretrained_backbone requested, but no ImageNet weights "
            "are downloaded and no checkpoint_load is set: the backbone "
            "trains FROM SCRATCH. Point general.checkpoint_load at a "
            "torchvision / Lightning checkpoint (models/convert.py "
            "load_deeplab_checkpoint reads it) to start from the "
            "reference's initialization.")


def save_state(path, trainer, epoch, **extra):
    """The resume anchor: the model, the optimizer and the epochs done."""
    save_tree(path, {"model": trainer.model.state_dict(),
                     "optimizer": trainer.optimizer.state_dict(),
                     "epoch": int(epoch), **extra})


def restore_state(path, trainer):
    """Load a `save_state` tree into the trainer (the optimizer's moments
    onto the parameters' device). Returns the tree."""
    tree = load_tree(path)
    trainer.model.load_state_dict(tree["model"])
    trainer.optimizer.load_state_dict(tree["optimizer"])
    return tree


def train(exp: dict, env: dict, args, exp_cfg_path=None, env_cfg_path=None,
          model=None):
    """A whole pretraining run on args.device (default "cuda"). args: seed,
    project_name, device. `model`: a DeepLabV3 to train (default R101 drawn
    from --seed, computing in model.compute_dtype). Over several ranks
    (module docstring) each rank runs this with the same arguments.
    Returns (the SegTrainer, the best val mean IoU)."""
    seed = getattr(args, "seed", 123)
    seed_everything(seed)
    audit_exp_keys(exp, "pretrain")
    compute_dtype = seg_compute_dtype(exp.get("model"))
    device = resolve_device(getattr(args, "device", "cuda"))
    mesh = mesh_from_env(device)
    if mesh is not None:
        device = mesh.device
    warn_pretrained_backbone(exp)
    model_path, logger = setup_experiment(
        exp, env, exp_cfg_path, env_cfg_path,
        getattr(args, "project_name", "pretrain"), mesh)

    cfg_dm = exp["data_module"]
    split = load_split(os.path.join(
        cfg_dm["root"], cfg_dm["data_preprocessing"]["split_file"]))
    output_size = tuple(exp.get("output_size", (240, 320)))
    num_classes = exp["model"]["num_classes"]

    def mk(key, mode):
        return ScanNet(root=cfg_dm["root"], img_list=split[key], mode=mode,
                       output_size=output_size)

    bs = cfg_dm["batch_size"]
    train_dl = DataLoader(mk("train", "train"), batch_size=bs,
                          shuffle=cfg_dm.get("shuffle", True),
                          drop_last=cfg_dm.get("drop_last", False), seed=seed)
    val_dl = DataLoader(mk("val", "val"), batch_size=bs)
    test_dl = DataLoader(mk("test", "test"), batch_size=bs)
    if mesh is not None:
        for dl in (train_dl, val_dl, test_dl):
            dl.shard(mesh.rank, mesh.size)

    if model is None:
        model = DeepLabV3(num_classes=num_classes, device=device,
                          generator=torch.Generator().manual_seed(seed),
                          compute_dtype=compute_dtype)
    trainer = SegTrainer(model, exp["optimizer"], device=device, mesh=mesh)
    ckpt_load = exp["general"].get("checkpoint_load")
    trainer.init(load_deeplab(ckpt_load, map_location=device)
                 if exp.get("trainer", {}).get("load_from_checkpoint")
                 and ckpt_load else None)

    # resume: the model, the optimizer's moments and the best score
    # (Lightning's resume_from_checkpoint keeps all three, ref
    # scripts/pretrain.py:97-101; a best restarted at -1 would let the
    # first resumed epoch overwrite best_ckpt with a worse model). A
    # last_ckpt written without best_miou resumes at -1
    start_epoch, best_miou = 0, -1.0
    resume_dir = os.path.join(model_path, "last_ckpt")
    if exp.get("trainer", {}).get("resume_from_checkpoint") and \
            os.path.isdir(resume_dir):
        tree = restore_state(resume_dir, trainer)
        start_epoch = int(tree["epoch"])
        best_miou = float(tree.get("best_miou", -1.0))
        print(f"[pretrain] resumed from {resume_dir} at epoch {start_epoch}"
              f" (best val mean IoU {best_miou})", flush=True)

    max_epochs = exp["trainer"]["max_epochs"]
    check_val_every = max(1, int(exp.get("trainer", {}).get(
        "check_val_every_n_epoch", 1)))
    save_last = bool(exp.get("trainer", {}).get("save_last", True))
    meters = {m: SemanticsMeter(num_classes, mesh) for m in ("train", "val",
                                                             "test")}
    # opt-in profiler (ref: scripts/pretrain.py:89-94): a torch.profiler
    # trace of the first epoch this run trains, and each phase's seconds
    # (rank 0's under a mesh)
    profile = bool(exp.get("trainer", {}).get("profiler", False)) and (
        mesh is None or mesh.rank == 0)
    timer = StepTimer(os.path.join(model_path, "profile_steps.jsonl")
                      if profile else None)
    for epoch in range(start_epoch, max_epochs):
        lr = epoch_lr(exp, epoch)
        meters["train"].clear()
        with maybe_trace(profile and epoch == start_epoch,
                         os.path.join(model_path, "torch_trace")):
            run_epoch(trainer, train_dl, bs, lr, meters["train"], logger,
                      "train", train=True, epoch=epoch, seed=seed)
        timer.tick("train_epoch", epoch=epoch)
        miou, tacc, macc = meters["train"].measure()
        logger.log({"train/mean_IoU": miou, "train/total_accuracy": tacc,
                    "train/mean_accuracy": macc, "lr": lr}, step=epoch)

        # best_ckpt moves only on a validation epoch, as Lightning's
        # val-monitored ModelCheckpoint (ref pretrain.py:70-78)
        if (epoch + 1) % check_val_every == 0:
            meters["val"].clear()
            run_epoch(trainer, val_dl, bs, lr, meters["val"], None, "val",
                      train=False)
            miou, tacc, macc = meters["val"].measure()
            logger.log({"val/mean_IoU": miou, "val/total_accuracy": tacc,
                        "val/mean_accuracy": macc}, step=epoch)
            if miou > best_miou:
                best_miou = miou
                on_rank0(mesh, save_deeplab,
                         os.path.join(model_path, "best_ckpt"),
                         trainer.model.state_dict())
            timer.tick("val_epoch", epoch=epoch)
        # trainer.save_last: false turns the per-epoch resume anchor off
        # (R101 with Adam's moments: ~0.7 GB a write)
        if save_last:
            on_rank0(mesh, save_state, resume_dir, trainer, epoch + 1,
                     best_miou=best_miou)
            timer.tick("last_ckpt", epoch=epoch)

    meters["test"].clear()
    run_epoch(trainer, test_dl, bs, epoch_lr(exp, 0), meters["test"], None,
              "test", train=False)
    miou, tacc, macc = meters["test"].measure()
    logger.log({"test/mean_IoU": miou, "test/total_accuracy": tacc,
                "test/mean_accuracy": macc})
    timer.tick("test")
    timer.close()
    logger.close()
    return trainer, best_miou
