"""Experiment folder + logger setup shared by the entry points (counterpart
of the JAX package's train/experiment.py; ref: scripts/pretrain.py:18-56,
scripts/train_joint.py:52-78)."""

import os
import random
import shutil

import numpy as np

from ..config import flatten_dict
from ..utils.logger import MetricsLogger, NullLogger


def seed_everything(seed: int):
    """Seed Python's and numpy's global generators, as the JAX package
    does. The port's own draws come from explicit torch.Generators, so no
    global torch seed is set."""
    random.seed(seed)
    np.random.seed(seed)


def on_rank0(mesh, fn, *args, **kwargs):
    """fn(*args, **kwargs) on rank 0 only (checkpoints, dumps), then a
    barrier, so that no rank reads what rank 0 is still writing; without a
    mesh, just the call."""
    if mesh is None or mesh.rank == 0:
        fn(*args, **kwargs)
    if mesh is not None:
        mesh.barrier()


def setup_experiment(exp: dict, env: dict, exp_cfg_path: str | None,
                     env_cfg_path: str | None, project_name: str,
                     mesh=None):
    """Create the run folder, copy configs for provenance, build the logger.
    Returns (model_path, logger). Mutates exp['general']['name'] to the run
    folder like the reference does. Under a mesh rank 0 makes the folder
    and logs, behind a barrier; the other ranks get a NullLogger."""
    model_path = os.path.join(env["results"], exp["general"]["name"])
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        exp["general"]["name"] = model_path
        return model_path, NullLogger()
    # a resuming run must keep the folder: it holds the `last_ckpt` resume
    # anchor the run is about to restore (resume wins over
    # clean_up_folder_if_exists, as in the reference, ref
    # scripts/pretrain.py:97-101)
    resuming = bool(exp.get("trainer", {}).get("resume_from_checkpoint"))
    if exp["general"].get("clean_up_folder_if_exists", False) and not resuming:
        shutil.rmtree(model_path, ignore_errors=True)
    os.makedirs(model_path, exist_ok=True)

    for p in (exp_cfg_path, env_cfg_path):
        if p and os.path.isfile(p):
            shutil.copy(p, os.path.join(model_path, os.path.split(p)[-1]))

    exp["general"]["name"] = model_path
    logger = MetricsLogger(model_path, project_name=project_name)
    logger.log_hyperparams(flatten_dict(exp))
    if mesh is not None:
        mesh.barrier()
    return model_path, logger
