from .rays import get_rays, nerf_matrix_to_ngp

__all__ = ["get_rays", "nerf_matrix_to_ngp"]
