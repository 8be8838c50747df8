"""DeepLabV3-R101 pretraining on ScanNet-25k (the port's counterpart of
scripts/pretrain.py, with the reference's flags, ref:
scripts/pretrain.py:117-133), on the card unless --device cpu:

  python -m ucsa_neural_rendering_tpu_torch.scripts.pretrain \\
      --exp cfg/exp/pretrain_scannet_25k_deeplabv3.yml [--device cpu]

Data-parallel over N ranks (one a card; gloo on the CPU with --device
cpu, NCCL on the cards; parallel/mesh.py), under torch's launcher:

  python -m torch.distributed.run --nproc-per-node N \\
      -m ucsa_neural_rendering_tpu_torch.scripts.pretrain \\
      --exp cfg/exp/pretrain_scannet_25k_deeplabv3.yml ...

It needs the split file under data_module.root (make it with
`python -m ucsa_neural_rendering_tpu_torch.scripts.create_split`). The
environment YAML is cfg/env/$ENV_WORKSTATION_NAME.yml (default env.yml)
under the repository root; an absolute ENV_WORKSTATION_NAME names a file
<name>.yml anywhere. Set trainer.resume_from_checkpoint: true in the
experiment to continue from the run's last_ckpt.
"""

import argparse

import torch

from ..config import load_exp_and_env
from ..parallel import shutdown
from ..train import pretrain_loop
from ..utils.device import resolve_device, set_deterministic
from .train_joint import PRECISION, ROOT_DIR


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog=PRECISION)
    parser.add_argument("--exp",
                        default="cfg/exp/pretrain_scannet_25k_deeplabv3.yml",
                        help="experiment YAML, relative to the repository "
                             "root or absolute")
    parser.add_argument("--seed", default=123, type=int)
    parser.add_argument("--project_name", default="pretrain")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns pretrain_loop.train's (SegTrainer, best val mean IoU)."""
    args = parse_args(argv)
    resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = True
    set_deterministic()
    exp, env, exp_p, env_p = load_exp_and_env(ROOT_DIR, args.exp)
    return pretrain_loop.train(exp, env, args, exp_p, env_p)


if __name__ == "__main__":
    main()
    shutdown()
