"""Occupancy grid: lookups and refresh (counterpart of
ucsa_neural_rendering_tpu/ops/occupancy.py).

The grid is a RES³ f32 EMA of densities over the cubic [-bound, bound]³
volume, flat index (x·r + y)·r + z. On the render and training paths the
lookups run fused inside the `occ_placement` kernel (ops/placement.py);
the plain lookups here are its reference and the CPU path. The refresh
(`update_grid`) probes the density at jittered cell centres of one x-slab
and folds it in with `occ_grid_update`, the wrapper of the CUDA kernel
csrc/occ_grid_update.cu (plain version `occ_grid_update_plain` on CPU
tensors).
"""

from dataclasses import dataclass

import torch

from .. import kernels
from ..utils.device import resolve_device

DEFAULT_RES = 128


@dataclass(frozen=True)
class OccupancyConfig:
    resolution: int = DEFAULT_RES
    decay: float = 0.62
    update_every: int = 16
    refresh_slabs: int = 4


def init_grid(cfg: OccupancyConfig = OccupancyConfig(),
              device="cuda") -> torch.Tensor:
    """Optimistic init: every cell occupied."""
    r = cfg.resolution
    return torch.ones((r, r, r), dtype=torch.float32,
                      device=resolve_device(device))


def cell_index(xyz: torch.Tensor, bound: float, r: int) -> torch.Tensor:
    """Flat nearest-cell index (x·r + y)·r + z of points [..., 3].

    The JAX package truncates toward zero with a saturating int32 cast and
    then clips to [0, r-1]; clamping in float first and truncating gives the
    same cell for every finite point, and keeps far-away points (the 1e10
    miss sentinel) clear of int overflow."""
    v = (xyz + bound) / (2.0 * bound) * r
    cell = v.clamp(0.0, float(r - 1)).to(torch.int64)
    return (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]


def density_at(grid: torch.Tensor, xyz: torch.Tensor,
               bound: float) -> torch.Tensor:
    """Raw EMA density at points xyz [..., 3] (nearest cell)."""
    r = grid.shape[0]
    return grid.reshape(-1)[cell_index(xyz, bound, r)]


def occupancy_at(grid: torch.Tensor, xyz: torch.Tensor, bound: float,
                 floor: float = 0.01,
                 density_threshold: float = 0.01) -> torch.Tensor:
    """Occupancy weights in {floor, 1} for points xyz [..., 3]."""
    sigma = density_at(grid, xyz, bound)
    return torch.where(sigma > density_threshold, torch.ones_like(sigma),
                       torch.full_like(sigma, floor))


def occ_grid_update_plain(grid: torch.Tensor, sigmas: torch.Tensor,
                          offset: int, decay: float) -> torch.Tensor:
    """Plain version of the occ_grid_update kernel: the whole grid times
    decay, then the max with the fresh densities sigmas [M] on the flat
    cells [offset, offset + M) → a new grid."""
    flat = grid.reshape(-1) * decay
    seg = flat[offset:offset + sigmas.shape[0]]
    seg.copy_(torch.maximum(seg, sigmas))
    return flat.reshape(grid.shape)


def occ_grid_update(grid: torch.Tensor, sigmas: torch.Tensor, offset: int,
                    decay: float) -> torch.Tensor:
    """grid [r,r,r] f32, sigmas [M] f32 → the decayed grid with the max of
    sigmas folded in at flat cells [offset, offset + M), as a new tensor.
    CUDA tensors launch occ_grid_update; CPU tensors take the plain
    version."""
    if not grid.is_cuda:
        return occ_grid_update_plain(grid, sigmas, offset, decay)
    n_cells, m = grid.numel(), sigmas.shape[0]
    kernels.check(grid, "grid", torch.float32)
    kernels.check(sigmas, "sigmas", torch.float32, (m,), grid.device)
    if not 0 <= offset <= offset + m <= n_cells:
        raise ValueError(f"cells [{offset}, {offset + m}) outside the grid "
                         f"of {n_cells}")
    out = torch.empty_like(grid)
    if n_cells:
        kernels.launch("occ_grid_update", grid, sigmas, out, n_cells, offset,
                       m, float(decay))
    return out


def update_grid(grid: torch.Tensor, density_fn, bound: float,
                generator: torch.Generator | None = None,
                cfg: OccupancyConfig = OccupancyConfig(), chunk: int = 262144,
                slab_index: int | None = None,
                jitter: torch.Tensor | None = None) -> torch.Tensor:
    """EMA-update the grid with fresh densities at jittered cell centres.

    density_fn: [M, 3] → sigma [M]. With slab_index, only the cells of the
    slab_index-th of cfg.refresh_slabs contiguous x-slabs are probed (the
    whole grid still decays); None probes every cell. jitter [M, 3] in
    [0, 1) is drawn from `generator` (on its device) unless given. Returns a
    new grid.
    """
    r = cfg.resolution
    n_cells = r ** 3
    n_slabs = cfg.refresh_slabs if slab_index is not None else 1
    if r % n_slabs:
        raise ValueError(f"refresh_slabs ({n_slabs}) must divide resolution "
                         f"({r})")
    slab_cells = n_cells // n_slabs
    offset = (slab_index or 0) * slab_cells
    dev = grid.device
    flat = torch.arange(offset, offset + slab_cells, device=dev)
    cells = torch.stack([flat // (r * r), (flat // r) % r, flat % r],
                        dim=-1).to(torch.float32)
    if jitter is None:
        jitter = torch.rand((slab_cells, 3), generator=generator,
                            device=generator.device)
    xyz = (cells + jitter.to(dev)) / r * (2.0 * bound) - bound
    sigmas = torch.cat([density_fn(xyz[s:s + chunk])
                        for s in range(0, slab_cells, chunk)])
    return occ_grid_update(grid, sigmas.float().contiguous(), offset,
                           cfg.decay)
