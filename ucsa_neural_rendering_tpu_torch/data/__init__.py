from .augmentation import (augment, color_jitter, draw_augment_params,
                           host_augment, rescale_to_canonical)
from .cl_mixers import ScanNetCL, ScanNetCLJoint
from .label_loader import LabelLoaderAuto
from .loader import DataLoader, default_collate
from .rays import get_rays, get_rays_sampled, nerf_matrix_to_ngp
from .scannet import ScanNet
from .scannet_ngp import ScanNetNGP
from .scannet_ngp_joint import ScanNetNGPJoint
from .splits import create_split, load_split, save_split

__all__ = ["augment", "color_jitter", "draw_augment_params", "host_augment",
           "rescale_to_canonical", "ScanNetCL", "ScanNetCLJoint",
           "LabelLoaderAuto", "DataLoader", "default_collate", "get_rays",
           "get_rays_sampled", "nerf_matrix_to_ngp", "ScanNet",
           "ScanNetNGP", "ScanNetNGPJoint", "create_split", "load_split",
           "save_split"]
