"""Segmentation fine-tuning on a NeRF-only stage's renders (the port's
counterpart of scripts/train_finetune.py, with the reference's flags,
ref: scripts/train_finetune.py), on the card unless --device cpu:

  python -m ucsa_neural_rendering_tpu_torch.scripts.train_finetune \\
      --exp cfg/exp/one_step_finetune_nerf/s00_lr1e-5.yml \\
      --prev_exp_name one_step_nerf_only [--device cpu]

Data-parallel over N ranks (one a card; gloo on the CPU with --device
cpu, NCCL on the cards; parallel/mesh.py), under torch's launcher:

  python -m torch.distributed.run --nproc-per-node N \\
      -m ucsa_neural_rendering_tpu_torch.scripts.train_finetune \\
      --exp cfg/exp/one_step_finetune_nerf/s00_lr1e-5.yml ...

It reads the renders `<scene>/<prev_exp_name>/nerf_image` and
`nerf_label` that the train_joint CLI dumps with --exp_name
<prev_exp_name> --joint_train_epoch 0, and with cl.active: true the
ScanNet-25k split files. The environment YAML is
cfg/env/$ENV_WORKSTATION_NAME.yml (default env.yml) under the repository
root; an absolute ENV_WORKSTATION_NAME names a file <name>.yml anywhere.
"""

import argparse

import torch

from ..config import load_exp_and_env
from ..parallel import shutdown
from ..train import finetune_loop
from ..utils.device import resolve_device, set_deterministic
from .train_joint import PRECISION, ROOT_DIR


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog=PRECISION)
    parser.add_argument("--exp",
                        default="cfg/exp/one_step_finetune_nerf/"
                                "s00_lr1e-5.yml")
    parser.add_argument("--seed", default=123, type=int)
    parser.add_argument("--project_name", default="finetune")
    parser.add_argument("--prev_exp_name", default="one_step_nerf_only",
                        help="the NeRF-only stage whose renders to train on")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def train(exp, env, exp_cfg_path, env_cfg_path, args):
    """Programmatic entry, as the JAX package's: one fine-tuning run from
    loaded configs. Returns the SegTrainer."""
    return finetune_loop.train(exp, env, args, exp_cfg_path, env_cfg_path,
                               prev_exp_name=getattr(args, "prev_exp_name",
                                                     "one_step_nerf_only"))


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = True
    set_deterministic()
    exp, env, exp_p, env_p = load_exp_and_env(ROOT_DIR, args.exp)
    return train(exp, env, exp_p, env_p, args)


if __name__ == "__main__":
    main()
    shutdown()
