"""The multi-step continual-learning protocol over a scene sequence (a port
of the JAX package's train/cl_driver.py; ref: scripts/cl_deeplab.py:
11-91): stage i adds SCENE_ORDER[i] to exp["scenes"] and runs one
joint_loop.train stage under `<exp_name>/stage_<i>`; stage 0 loads the
pretrained seg checkpoint (general.checkpoint_load), stage i > 0 the
`deeplab_ckpt` stage i − 1 saved, and replays stage i − 1's predict dumps
as old-scene frames. The NeRF starts afresh every stage: only the seg net
and the dumped PNGs carry over.

Resume: a truthy `trainer.resume_from_checkpoint` on entry continues an
interrupted protocol. Stages whose `deeplab_ckpt` is on disk (written
after the predict dumps the next stage replays) are skipped, the first
unfinished stage resumes from its per-epoch `last_ckpt`, and the stages
after it start fresh.

Memory: a finished stage's JointTrainer (both models, both optimizers)
and its occupancy grid are dropped before the next stage builds its own,
then gc.collect() and torch.cuda.empty_cache() run, so the card's
allocated memory does not grow from stage to stage. The results hold no
tensor: each completed stage is returned as the path of its run folder
(its deeplab_ckpt, nerf_ckpt and last_ckpt are there), a skipped stage as
None.
"""

import copy
import gc
import os

import torch

from . import joint_loop

SCENE_ORDER = [f"scene{i:04d}_00" for i in range(10)]


def main(exp, env, args, exp_cfg_path=None, env_cfg_path=None,
         scene_order=None, render_cfg=None, val_scene_list=None,
         trainer_kwargs=None):
    """Run the protocol over scene_order (default SCENE_ORDER) on
    args.device (default "cuda"); args as joint_loop.train takes them.
    trainer_kwargs' models, when given, are templates: each stage trains a
    deep copy, so every stage's NeRF starts from the same weights, as a
    fresh stage's seeded init does. Returns one entry a stage: the run
    folder of a stage that ran, None for a skipped one."""
    scene_order = scene_order or SCENE_ORDER
    exp_name = args.exp_name
    exp["exp_name"] = exp_name
    exp["scenes"] = []
    exp.setdefault("trainer", {})
    resume_protocol = bool(exp["trainer"].get("resume_from_checkpoint"))

    prev_stage, stage = None, None
    results = []
    for i, new_scene in enumerate(scene_order):
        exp["scenes"].append(new_scene)
        prev_stage, stage = stage, f"stage_{i}"
        exp["general"]["name"] = f"{exp_name}/{stage}"
        run = os.path.join(env["results"], exp_name, stage)

        if resume_protocol and os.path.isdir(os.path.join(run,
                                                          "deeplab_ckpt")):
            print(f"[cl_driver] stage {i} ({new_scene}) already complete; "
                  f"skipping", flush=True)
            results.append(None)
            continue
        exp["trainer"]["resume_from_checkpoint"] = resume_protocol
        resume_protocol = False
        exp["trainer"]["load_from_checkpoint"] = True
        if i == 0:
            exp["general"]["load_pretrain"] = True
            old_model_path = exp["general"]["checkpoint_load"]
        else:
            exp["general"]["load_pretrain"] = False
            old_model_path = os.path.join(env["results"], exp_name,
                                          prev_stage, "deeplab_ckpt")
        exp["general"]["checkpoint_load"] = old_model_path

        print(f"[cl_driver] training on: {new_scene} (stage {i})",
              flush=True)
        stage_kwargs = copy.deepcopy(trainer_kwargs)
        trainer, occ_grid = joint_loop.train(
            exp, env, args, exp_cfg_path, env_cfg_path,
            render_cfg=render_cfg, val_scene_list=val_scene_list,
            trainer_kwargs=stage_kwargs)
        results.append(run)
        del trainer, occ_grid, stage_kwargs
        if i + 1 < len(scene_order):
            gc.collect()
            torch.cuda.empty_cache()
    return results
