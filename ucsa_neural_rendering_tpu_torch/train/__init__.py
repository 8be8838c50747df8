from . import (checkpoints, cl_driver, finetune_loop, joint_loop,
               pretrain_loop, seg_eval)
from .experiment import seed_everything, setup_experiment
from .joint_trainer import JointTrainer
from .nerf_trainer import NeRFTrainer, make_nerf_optimizer, nerf_losses
from .seg_trainer import (SegTrainer, cross_entropy_ignore,
                          make_seg_optimizer, poly_lr_factor)

__all__ = ["checkpoints", "cl_driver", "finetune_loop", "joint_loop",
           "pretrain_loop", "seg_eval", "seed_everything", "setup_experiment",
           "JointTrainer", "NeRFTrainer", "make_nerf_optimizer",
           "nerf_losses", "SegTrainer", "cross_entropy_ignore",
           "make_seg_optimizer", "poly_lr_factor"]
