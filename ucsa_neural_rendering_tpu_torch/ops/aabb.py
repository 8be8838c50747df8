"""Ray/AABB intersection (counterpart of ucsa_neural_rendering_tpu/ops/aabb.py).

The plain slab test. On the render path it runs fused inside the
`occ_placement` CUDA kernel (ops/placement.py); this version is its
reference and the CPU path.
"""

import torch

# miss rays' near/far value: far beyond any scene extent, but safe against
# f32 overflow in downstream sums (0.5*(z+z) stays finite)
MISS_SENTINEL = 1e10


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.2):
    """Slab test of rays [...,3] against one box aabb [6]
    (xmin, ymin, zmin, xmax, ymax, zmax) → (nears, fars) [...].

    Rays that miss get near == far == MISS_SENTINEL; a ray whose exit lies
    closer than min_near gets a zero-extent interval at min_near.
    """
    eps = 1e-15
    safe_d = torch.where(rays_d.abs() < eps,
                         torch.where(rays_d >= 0, eps, -eps), rays_d)
    inv_d = 1.0 / safe_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    miss = t_near > t_far  # disjoint slabs, tested before the clamps
    t_near = t_near.clamp_min(min_near)
    t_far = torch.maximum(t_far, t_near)
    sentinel = torch.full_like(t_near, MISS_SENTINEL)
    return torch.where(miss, sentinel, t_near), torch.where(miss, sentinel,
                                                            t_far)
