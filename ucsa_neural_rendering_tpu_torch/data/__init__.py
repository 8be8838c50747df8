from .augmentation import (augment, color_jitter, draw_augment_params,
                           host_augment)
from .loader import DataLoader, default_collate
from .rays import get_rays, get_rays_sampled, nerf_matrix_to_ngp
from .scannet_ngp_joint import ScanNetNGPJoint
from .splits import create_split, load_split, save_split

__all__ = ["augment", "color_jitter", "draw_augment_params", "host_augment",
           "DataLoader", "default_collate", "get_rays", "get_rays_sampled",
           "nerf_matrix_to_ngp", "ScanNetNGPJoint", "create_split",
           "load_split", "save_split"]
