"""Experiment-config key audit: warn on silently-ignored keys (a copy of
the JAX package's config/key_audit.py with the same tables, so that the port
warns on exactly the keys JAX warns on; the reasons of the ignored table
describe the port).

The reference consumes its YAML surface in scattered places (Lightning
`Trainer(**exp["trainer"])`, the data modules, the nets); a key that
nothing reads would otherwise be accepted and silently ignored. Each entry
point calls `audit_exp_keys(exp, entry)` after loading its config: every
flattened key must be either CONSUMED by that entry's loop or in the
DOCUMENTED-IGNORED table (torch/Lightning-isms the loops do not read, with
the reason recorded); anything else draws a warning.
"""

import warnings

# keys every entry reads (train/experiment.py, checkpoints, loops)
_COMMON_CONSUMED = {
    "general.name", "general.clean_up_folder_if_exists",
    "general.checkpoint_load", "general.load_pretrain",
    "model.num_classes", "model.compute_dtype",
    "trainer.resume_from_checkpoint", "trainer.load_from_checkpoint",
    "trainer.profiler", "trainer.save_last",
    "output_size", "exp_name", "name", "timestamp",
}

# torch/Lightning-isms the loops do not read; accepted without warning,
# reason recorded here (the audit's "reject with documentation" arm)
_IGNORED = {
    "data_module.num_workers": "host loader uses a single prefetch thread "
                               "(data/loader.py); no worker pool",
    "data_module.pin_memory": "batches are numpy until the trainer copies "
                              "them to the card (JointTrainer._batch); no "
                              "page-locked staging",
    "trainer.num_sanity_val_steps": "Lightning-ism; the loops run explicit "
                                    "validation passes",
    "trainer.gpus": "the card count is the world size: one rank a card "
                    "under `python -m torch.distributed.run "
                    "--nproc-per-node N` (parallel/mesh.py)",
    "trainer.accelerator": "the entry point's --device (utils/device.py); "
                           "over N ranks, the world size's cards "
                           "(parallel/mesh.py)",
    "trainer.find_unused_parameters": "DDP knob; the world size's ranks sum "
                                      "every gradient the step computed "
                                      "(parallel/mesh.py), no DDP wrapper",
    "trainer.precision": "precision policy is model-level "
                         "(model.compute_dtype) and the CLI's cuDNN TF32 "
                         "setting (scripts/train_joint.py)",
    "data_module.data_preprocessing.image_regex":
        "consumed by scripts/create_split.py at split-creation time",
    "data_module.data_preprocessing.val_ratio":
        "consumed by scripts/create_split.py at split-creation time",
    "model.pretrained": "the port downloads no torchvision COCO weights; "
                        "load a checkpoint via general.checkpoint_load "
                        "instead",
    "model.pretrained_backbone": "the port downloads no torchvision "
                                 "ImageNet backbone; load a checkpoint via "
                                 "general.checkpoint_load (models/convert.py "
                                 "load_deeplab_checkpoint)",
}

_ENTRY_CONSUMED = {
    "pretrain": {
        "data_module.root", "data_module.batch_size", "data_module.shuffle",
        "data_module.drop_last", "data_module.data_preprocessing.split_file",
        "lr_scheduler.active", "lr_scheduler.name",
        "lr_scheduler.poly_cfg.max_epochs", "lr_scheduler.poly_cfg.power",
        "lr_scheduler.poly_cfg.target_lr",
        "optimizer.lr", "optimizer.name", "optimizer.sgd_cfg.momentum",
        "optimizer.sgd_cfg.nesterov", "optimizer.sgd_cfg.weight_decay",
        "trainer.max_epochs", "trainer.check_val_every_n_epoch",
        "visualizer.store", "visualizer.store_n.train",
        "visualizer.store_n.val", "visualizer.store_n.test",
    },
    "joint": {
        "scenes", "val_scenes", "fix_nerf",
        "cl.active", "cl.25k_fraction", "cl.ngp_25k_ratio",
        "cl.replay_buffer_size", "cl.use_novel_viewpoints",
        "data_module.batch_size",
        "data_module.data_preprocessing.split_file",
        "data_module.data_preprocessing.split_file_cl",
        "data_module.shuffle", "data_module.drop_last",
        "optimizer.lr_seg", "optimizer.lr_nerf", "optimizer.name",
        "optimizer.sgd_cfg.momentum", "optimizer.sgd_cfg.nesterov",
        "optimizer.sgd_cfg.weight_decay",
        "trainer.max_epochs", "trainer.check_val_every_n_epoch",
        "visualizer.store", "visualizer.store_n.train",
        "visualizer.store_n.val", "visualizer.store_n.test",
        "lr_scheduler.active", "lr_scheduler.name",
        "lr_scheduler.poly_cfg.max_epochs", "lr_scheduler.poly_cfg.power",
        "lr_scheduler.poly_cfg.target_lr",
        "parity.double_softmax",
        # TPU nerf-model block (joint_loop.train builds SemanticNeRF from
        # it; joint_trainer reads use_occupancy / fused_image_step)
        "nerf.bound", "nerf.n_levels", "nerf.n_features",
        "nerf.log2_hashmap_size", "nerf.stochastic_table_grad",
        "nerf.stochastic_fwd", "nerf.n_rays", "nerf.use_occupancy",
        "nerf.fused_image_step",
        # round-5 dispatch-coalescing escape hatches (joint_loop.train
        # scan_fit; joint_trainer.fused_joint_step — both default True)
        "nerf.scan_epoch_fit", "nerf.fused_joint_step",
    },
    "finetune": {
        "scenes",
        "cl.active", "cl.25k_fraction", "cl.ngp_25k_ratio",
        "cl.use_novel_viewpoints", "cl.replay_buffer_size",
        "data_module.batch_size", "data_module.train_image",
        "data_module.train_label",
        "data_module.data_preprocessing.split_file",
        "data_module.data_preprocessing.split_file_cl",
        "data_module.shuffle", "data_module.drop_last",
        "optimizer.lr", "optimizer.name", "optimizer.sgd_cfg.momentum",
        "optimizer.sgd_cfg.nesterov", "optimizer.sgd_cfg.weight_decay",
        "trainer.max_epochs", "trainer.check_val_every_n_epoch",
        "visualizer.store", "visualizer.store_n.train",
        "visualizer.store_n.val", "visualizer.store_n.test",
        "lr_scheduler.active", "lr_scheduler.name",
        "lr_scheduler.poly_cfg.max_epochs", "lr_scheduler.poly_cfg.power",
        "lr_scheduler.poly_cfg.target_lr",
    },
}

# extension blocks validated by their own loaders: `renderer.*` by
# joint_loop.render_cfgs_from_exp (unknown-field warning there). `nerf.*`
# is NOT prefix-exempt: joint_loop/joint_trainer read it with bare .get()
# calls, so unknown nerf keys would be accepted and silently ignored —
# the exact failure mode this module exists to warn about. The consumed
# set is enumerated in _ENTRY_CONSUMED["joint"] below.
_VALIDATED_ELSEWHERE = ("renderer.",)

# entry-irrelevant but consumed by a sibling entry (e.g. `optimizer.lr`
# inside a joint config): no warning — reference configs share one schema
_ANY_CONSUMED = (_COMMON_CONSUMED
                 | _ENTRY_CONSUMED["pretrain"]
                 | _ENTRY_CONSUMED["joint"]
                 | _ENTRY_CONSUMED["finetune"])


def flatten_keys(d, prefix=""):
    out = []
    for k, v in d.items():
        kp = f"{prefix}{k}"
        if isinstance(v, dict):
            if v:
                out.extend(flatten_keys(v, kp + "."))
            else:
                out.append(kp)
        else:
            out.append(kp)
    return out


def audit_exp_keys(exp: dict, entry: str, warn=True):
    """Return (ignored, unknown) key lists for `exp` as seen by `entry`
    ('pretrain' | 'joint' | 'finetune'); warn on unknown keys."""
    consumed = _COMMON_CONSUMED | _ENTRY_CONSUMED[entry]
    ignored, unknown = [], []
    for k in flatten_keys(exp):
        if k in consumed or k.startswith(_VALIDATED_ELSEWHERE):
            continue
        if k in _IGNORED:
            ignored.append(k)
        elif k in _ANY_CONSUMED:
            continue
        else:
            unknown.append(k)
    if warn and unknown:
        warnings.warn(
            f"[{entry}] config keys not consumed by any entry point and not "
            f"in the documented-ignored table: {sorted(unknown)} — they will "
            f"have NO effect (see config/key_audit.py)")
    return ignored, unknown


def ignored_reason(key: str) -> str | None:
    return _IGNORED.get(key)
