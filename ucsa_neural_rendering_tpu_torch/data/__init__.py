from .rays import get_rays, get_rays_sampled, nerf_matrix_to_ngp

__all__ = ["get_rays", "get_rays_sampled", "nerf_matrix_to_ngp"]
