"""Joint NeRF + segmentation adaptation, one stage (the port's counterpart
of scripts/train_joint.py, with the reference's flags, ref:
scripts/train_joint.py:16-44), on the card unless --device cpu:

  python -m ucsa_neural_rendering_tpu_torch.scripts.train_joint \\
      --exp cfg/exp/one_step_joint/s00_lr1e-5.yml --exp_name my_exp \\
      --nerf_train_epoch 10 --joint_train_epoch 50 [--device cpu]

Data-parallel over N ranks (one a card; gloo on the CPU with --device
cpu, NCCL on the cards; parallel/mesh.py), under torch's launcher:

  python -m torch.distributed.run --nproc-per-node N \\
      -m ucsa_neural_rendering_tpu_torch.scripts.train_joint \\
      --exp cfg/exp/one_step_joint/s00_lr1e-5.yml --exp_name my_exp ...

The environment YAML is cfg/env/$ENV_WORKSTATION_NAME.yml (default
env.yml) under the repository root; an absolute ENV_WORKSTATION_NAME names
a file <name>.yml anywhere.
"""

import argparse
import os

import torch

from ..config import load_exp_and_env
from ..parallel import shutdown
from ..train import joint_loop
from ..utils.device import resolve_device, set_deterministic

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PRECISION = (
    "Precision: the segmentation net's convolutions run in TF32 on the card "
    "(cuDNN's allow_tf32, which this CLI sets; its labels agree with an f32 "
    "run's on 0.997 of the pixels, and the JAX package's f32 convolutions "
    "run as bf16 passes on a TPU); everything else runs in f32, the NeRF "
    "MLPs' products in bf16 as in the JAX package. The CLI also sets cuDNN's "
    "deterministic algorithms, so a run repeats bit for bit on one card.")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog=PRECISION)
    parser.add_argument("--exp",
                        default="cfg/exp/one_step_joint/s00_lr1e-5.yml")
    parser.add_argument("--exp_name", default="debug",
                        help="name of this continual-learning experiment")
    parser.add_argument("--fix_nerf", action="store_true",
                        help="fix the NeRF during joint training")
    parser.add_argument("--seed", default=123, type=int)
    parser.add_argument("--project_name", default="test_one_by_one")
    parser.add_argument("--nerf_train_epoch", default=10, type=int)
    parser.add_argument("--joint_train_epoch", default=10, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu "
                             "(the plain PyTorch versions of the kernels)")
    return parser.parse_args(argv)


def train(exp, env, exp_cfg_path, env_cfg_path, args):
    """Programmatic entry, as the JAX package's: one stage from loaded
    configs. Returns (the JointTrainer, the occupancy grid)."""
    exp["general"].setdefault("load_pretrain", True)
    return joint_loop.train(exp, env, args, exp_cfg_path, env_cfg_path)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = True
    set_deterministic()
    exp, env, exp_p, env_p = load_exp_and_env(ROOT_DIR, args.exp)
    exp["general"]["load_pretrain"] = True
    return train(exp, env, exp_p, env_p, args)


if __name__ == "__main__":
    main()
    shutdown()
