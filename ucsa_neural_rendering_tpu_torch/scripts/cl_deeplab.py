"""The multi-step continual-learning protocol over ScanNet scenes
0000-0009 (the port's counterpart of scripts/cl_deeplab.py, with the
reference's flags, ref: scripts/cl_deeplab.py:26-51), on the card unless
--device cpu:

  python -m ucsa_neural_rendering_tpu_torch.scripts.cl_deeplab \\
      --exp cfg/exp/multi_step/cl_base.yml --exp_name my_cl_run \\
      --nerf_train_epoch 10 --joint_train_epoch 10 [--device cpu]

Data-parallel over N ranks (one a card; gloo on the CPU with --device
cpu, NCCL on the cards; parallel/mesh.py), under torch's launcher:

  python -m torch.distributed.run --nproc-per-node N \\
      -m ucsa_neural_rendering_tpu_torch.scripts.cl_deeplab \\
      --exp cfg/exp/multi_step/cl_base.yml --exp_name my_cl_run ...

With cl.active: true it needs the ScanNet-25k split files (make them with
`python -m ucsa_neural_rendering_tpu_torch.scripts.create_split`). The
environment YAML is cfg/env/$ENV_WORKSTATION_NAME.yml (default env.yml)
under the repository root; an absolute ENV_WORKSTATION_NAME names a file
<name>.yml anywhere. Set trainer.resume_from_checkpoint: true in the
experiment to continue an interrupted protocol.
"""

import argparse

import torch

from ..config import load_exp_and_env
from ..parallel import shutdown
from ..train import cl_driver
from ..utils.device import resolve_device, set_deterministic
from .train_joint import PRECISION, ROOT_DIR

SCENE_ORDER = cl_driver.SCENE_ORDER


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog=PRECISION)
    parser.add_argument("--exp", default="cfg/exp/multi_step/cl_base.yml")
    parser.add_argument("--exp_name", default="debug")
    parser.add_argument("--seed", default=123, type=int)
    parser.add_argument("--fix_nerf", action="store_true")
    parser.add_argument("--project_name", default="test_one_by_one")
    parser.add_argument("--nerf_train_epoch", default=10, type=int)
    parser.add_argument("--joint_train_epoch", default=10, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu "
                             "(the plain PyTorch versions of the kernels)")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns cl_driver.main's per-stage results (run folders)."""
    args = parse_args(argv)
    resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = True
    set_deterministic()
    exp, env, exp_p, env_p = load_exp_and_env(ROOT_DIR, args.exp)
    return cl_driver.main(exp, env, args, exp_p, env_p)


if __name__ == "__main__":
    main()
    shutdown()
