from .augmentation import augment, color_jitter, draw_augment_params
from .rays import get_rays, get_rays_sampled, nerf_matrix_to_ngp

__all__ = ["augment", "color_jitter", "draw_augment_params", "get_rays",
           "get_rays_sampled", "nerf_matrix_to_ngp"]
