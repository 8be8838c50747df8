"""Per-ray sample placement of the render and training paths: the two CUDA
kernels that place samples, with their plain PyTorch versions.

`occ_placement` — occupancy-guided coarse placement (the JAX package's
  ops/renderer.py:262-296 over ops/aabb.py, ops/occupancy.py and
  ops/sampling.py): AABB slab test → n_cand uniformly spaced candidates →
  grid weights (binary occupancy, or proposal alphas from the grid density)
  → det inverse-CDF → sorted z [N, S].
`importance_resample` — the fine pass's placement (ops/renderer.py:305-325):
  weights of the coarse samples → det inverse-CDF → stable merge of coarse
  and new samples (coarse first on equal z, like a stable argsort).

Both take the inverse-CDF positions `u`: none for the det render
placement, or per-ray uniforms [N, S] for a training step. The plain
versions use u in its order, as the JAX package does; the kernels write
each ray's z sorted (occ_placement walks the cdf once through the ray's
sorted u; importance_resample, a warp per ray, sorts its new z by rank).
The inverse CDF is monotone, so the coarse z (sorted anyway) are the same,
and the fine pass's new z are the same set in another order, which the
merge's z, order-gathered values and everything downstream do not see.

The wrappers launch the kernels (csrc/occ_placement.cu,
csrc/importance_resample.cu) on CUDA tensors and take the plain versions on
CPU tensors.
"""

import torch

from .. import kernels
from .aabb import near_far_from_aabb
from .compositing import composite_weights
from .occupancy import density_at, occupancy_at
from .sampling import det_u, linspace, sample_pdf, stratified_samples


def _aabb(bound: float, device) -> torch.Tensor:
    return torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=device)


def occ_placement_plain(rays_o, rays_d, grid, bound: float, n_samples: int,
                        n_cand: int = 128, min_near: float = 0.2,
                        proposal: bool = False, floor: float = 0.01,
                        threshold: float = 0.01, density_scale: float = 1.0,
                        u: torch.Tensor | None = None):
    """Plain version of the occ_placement kernel → sorted z [N, n_samples]."""
    nears, fars = near_far_from_aabb(rays_o, rays_d,
                                     _aabb(bound, rays_o.device), min_near)
    cand_z = stratified_samples(nears, fars, n_cand)
    cand_xyz = rays_o[:, None, :] + rays_d[:, None, :] * cand_z[..., None]
    if proposal:
        # graded local opacity of each candidate from the grid's EMA density
        sigma_c = density_at(grid, cand_xyz, bound)
        dz = ((fars - nears) / n_cand)[:, None]
        alpha = 1.0 - torch.exp(-sigma_c * dz * density_scale)
        w_occ = alpha.clamp_min(floor)
    else:
        w_occ = occupancy_at(grid, cand_xyz, bound, floor, threshold)
    z_mid = 0.5 * (cand_z[..., 1:] + cand_z[..., :-1])
    z_vals = sample_pdf(z_mid, w_occ[..., 1:-1], n_samples, u)
    return torch.sort(z_vals, dim=-1).values


def _check_u(u, n: int, s: int, device) -> tuple[torch.Tensor, int]:
    """The kernels' u argument and its row stride: the shared det positions
    (stride 0) when u is None, else per-ray u [n, s] (stride s)."""
    if u is None:
        return det_u(s, device), 0
    kernels.check(u, "u", torch.float32, (n, s), device)
    return u, s


def occ_placement(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  grid: torch.Tensor, bound: float, n_samples: int,
                  n_cand: int = 128, min_near: float = 0.2,
                  proposal: bool = False, floor: float = 0.01,
                  threshold: float = 0.01, density_scale: float = 1.0,
                  u: torch.Tensor | None = None):
    """rays [N,3] f32, grid [r,r,r] f32, u None or [N, n_samples] f32 →
    sorted z [N, n_samples] f32. CUDA tensors launch occ_placement; CPU
    tensors take the plain version."""
    if not rays_o.is_cuda:
        return occ_placement_plain(rays_o, rays_d, grid, bound, n_samples,
                                   n_cand, min_near, proposal, floor,
                                   threshold, density_scale, u)
    n = rays_o.shape[0]
    r = grid.shape[0]
    dev = rays_o.device
    f32 = torch.float32
    kernels.check(rays_o, "rays_o", f32, (n, 3))
    kernels.check(rays_d, "rays_d", f32, (n, 3), dev)
    kernels.check(grid, "grid", f32, (r, r, r), dev)
    if n_cand < 3 or n_samples < 1:
        raise ValueError(f"occ_placement takes 3 or more candidates and 1 or "
                         f"more samples, got {n_cand}, {n_samples}")
    u, u_stride = _check_u(u, n, n_samples, dev)
    z = torch.empty((n, n_samples), dtype=f32, device=dev)
    if n:
        kernels.launch("occ_placement", rays_o, rays_d, grid,
                       linspace(0.0, 1.0, n_cand, dev), u, z, n, n_cand,
                       n_samples, r, float(bound), float(min_near),
                       int(bool(proposal)), float(floor), float(threshold),
                       float(density_scale), u_stride)
    return z


# the kernel's kMaxMerged: 4 rays a block, each with 4 four-byte words per
# merged sample in shared memory, within the default 48 KB → 768
RESAMPLE_MAX_MERGED = 48 * 1024 // (4 * 4 * 4)


def importance_resample_plain(z_vals, sigmas, n_new: int,
                              density_scale: float = 1.0,
                              u: torch.Tensor | None = None):
    """Plain version of the importance_resample kernel →
    (new_z [N, n_new], z_sorted [N, S+n_new], order [N, S+n_new] int64),
    order indexing the concatenation [z_vals, new_z]."""
    w = composite_weights(z_vals, sigmas, density_scale)
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    new_z = sample_pdf(z_mid, w[:, 1:-1], n_new, u)
    z_all = torch.cat([z_vals, new_z], dim=-1)
    z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
    return new_z, z_sorted, order


def importance_resample(z_vals: torch.Tensor, sigmas: torch.Tensor,
                        n_new: int, density_scale: float = 1.0,
                        u: torch.Tensor | None = None):
    """z [N,S] f32 sorted along each ray (the kernel merges by rank),
    sigma [N,S] f32, u None or [N, n_new] f32 →
    (new_z, z_sorted, order) as in importance_resample_plain (the kernel's
    new_z in sorted order). CUDA tensors launch importance_resample; CPU
    tensors take the plain version."""
    if not z_vals.is_cuda:
        return importance_resample_plain(z_vals, sigmas, n_new,
                                         density_scale, u)
    n, s = z_vals.shape
    dev = z_vals.device
    f32 = torch.float32
    kernels.check(z_vals, "z_vals", f32, (n, s))
    kernels.check(sigmas, "sigmas", f32, (n, s), dev)
    if s < 3 or n_new < 1 or s + n_new > RESAMPLE_MAX_MERGED:
        raise ValueError(f"importance_resample takes 3 or more coarse and 1 "
                         f"or more new samples, at most "
                         f"{RESAMPLE_MAX_MERGED} in all, got {s} + {n_new}")
    u, u_stride = _check_u(u, n, n_new, dev)
    new_z = torch.empty((n, n_new), dtype=f32, device=dev)
    z_sorted = torch.empty((n, s + n_new), dtype=f32, device=dev)
    order = torch.empty((n, s + n_new), dtype=torch.int64, device=dev)
    if n:
        kernels.launch("importance_resample", z_vals, sigmas, u, new_z,
                       z_sorted, order, n, s, n_new, float(density_scale),
                       u_stride)
    return new_z, z_sorted, order
