"""Occupancy grid lookups (counterpart of
ucsa_neural_rendering_tpu/ops/occupancy.py).

The grid is render input state here: a RES³ f32 EMA of densities over the
cubic [-bound, bound]³ volume, flat index (x·r + y)·r + z. Its refresh
(`update_grid`) belongs to the training slice. On the render path the
lookups run fused inside the `occ_placement` kernel (ops/placement.py);
these plain versions are its reference and the CPU path.
"""

from dataclasses import dataclass

import torch

from ..utils.device import resolve_device

DEFAULT_RES = 128


@dataclass(frozen=True)
class OccupancyConfig:
    resolution: int = DEFAULT_RES
    decay: float = 0.62
    update_every: int = 16
    refresh_slabs: int = 4
    probe_sampled: bool = True


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
