"""Volumetric Semantic-NeRF render of a ray batch (counterpart of
ucsa_neural_rendering_tpu/ops/renderer.py, occupancy-grid path).

  coarse: occ_placement — AABB → occupancy-grid candidates → inverse-CDF
          (binary occupancy or proposal placement) → density pass
  fine:   importance_resample — inverse-CDF from the detached coarse
          weights, stable merge → second density pass
  shade:  color / semantics MLPs, composite_rays (masked weighted sums)
  out:    rgb [N,3], semantic mass [N,C], z-depth [N]

`render_rays` is the deterministic render (det inverse-CDF positions, no
gradient); `render_rays_train` is a training step's render: the caller's
per-ray uniforms place the samples (the JAX package's keyed branch), and
the outputs carry gradients to the model's parameters.

On CUDA tensors the steps above run as the hand-written kernels
(hash_encode_fwd and mlp_fwd inside the density passes, mlp_fwd for the
color and semantics; composite_bwd, mlp_bwd and hash_encode_bwd in the
backward); on CPU tensors as their plain PyTorch versions (on the card too
inside `kernels.plain_versions()`).

Not ported yet: the dense path without an occupancy grid, probe placement,
cell-packed tables (`packed=`, also the TPU-only train-step packing) and
ray sharding (`mesh=`).
"""

from dataclasses import dataclass, replace

import torch

from .compositing import composite_rays
from .placement import importance_resample, occ_placement


@dataclass(frozen=True)
class RenderConfig:
    num_steps: int = 256
    upsample_steps: int = 256
    density_scale: float = 1.0
    min_near: float = 0.2
    weight_mask_threshold: float = 1e-4
    max_ray_batch: int = 4096
    # early termination: a stage-1 pass of stage1_steps renders every ray;
    # the top refine_fraction rays by residual transmittance (above
    # term_threshold) re-render at the full budget
    early_stop: bool = False
    stage1_steps: int = 8
    refine_fraction: float = 0.25
    term_threshold: float = 1e-4
    # occupancy-guided coarse placement
    occ_candidates: int = 128
    occ_floor: float = 0.01
    occ_density_threshold: float = 0.01
    # graded grid-density alphas instead of binary occupancy weights
    proposal_placement: bool = False


def _clip_to_aabb(xyz: torch.Tensor, bound: float) -> torch.Tensor:
    return xyz.clamp(-bound, bound)


def _points(rays_o, rays_d, z, bound):
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return _clip_to_aabb(xyz, bound).reshape(-1, 3)


def _render(model, rays_o, rays_d, direction_norms, cfg, occ_grid,
            u_coarse=None, u_fine=None):
    if occ_grid is None:
        raise NotImplementedError(
            "the dense path without an occupancy grid is not ported yet")
    bound = model.bound
    n = rays_o.shape[0]

    # --- coarse pass ---
    z_vals = occ_placement(rays_o, rays_d, occ_grid, bound, cfg.num_steps,
                           cfg.occ_candidates, cfg.min_near,
                           cfg.proposal_placement, cfg.occ_floor,
                           cfg.occ_density_threshold, cfg.density_scale,
                           u_coarse)
    sigma, geo = model.density(_points(rays_o, rays_d, z_vals, bound))
    sigma = sigma.reshape(n, cfg.num_steps)
    geo = geo.reshape(n, cfg.num_steps, -1)

    # --- fine pass: importance-resample from the detached coarse weights ---
    if cfg.upsample_steps > 0:
        new_z, z_vals, order = importance_resample(
            z_vals, sigma.detach(), cfg.upsample_steps, cfg.density_scale,
            u_fine)
        new_sigma, new_geo = model.density(
            _points(rays_o, rays_d, new_z, bound))
        sigma = torch.take_along_dim(
            torch.cat([sigma, new_sigma.reshape(n, -1)], dim=-1), order,
            dim=-1)
        geo = torch.take_along_dim(
            torch.cat([geo, new_geo.reshape(n, cfg.upsample_steps, -1)],
                      dim=1), order[..., None], dim=1)

    # --- shade + composite ---
    t_total = z_vals.shape[-1]
    geo = geo.reshape(n * t_total, -1)
    dirs = rays_d[:, None, :].expand(n, t_total, 3).reshape(-1, 3)
    rgbs = model.color(dirs, geo).reshape(n, t_total, 3)
    sems = model.semantics(geo).reshape(n, t_total, -1)
    image, semantics, depth = composite_rays(z_vals, sigma, rgbs, sems,
                                             direction_norms,
                                             cfg.density_scale,
                                             cfg.weight_mask_threshold)
    return {"image": image, "semantics": semantics, "depth": depth}


@torch.no_grad()
def render_rays(model, rays_o: torch.Tensor, rays_d: torch.Tensor,
                direction_norms: torch.Tensor, cfg: RenderConfig = RenderConfig(),
                occ_grid: torch.Tensor | None = None):
    """Render a flat batch of rays deterministically.

    rays_o, rays_d: [N, 3] origins / unit directions; direction_norms: [N]
    norms of the unnormalized pixel directions; occ_grid: [r, r, r] density
    grid.
    Returns dict image [N,3], semantics [N,C] (unnormalized mass), depth [N].
    """
    return _render(model, rays_o, rays_d, direction_norms, cfg, occ_grid)


def render_rays_train(model, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      direction_norms: torch.Tensor, u_coarse: torch.Tensor,
                      u_fine: torch.Tensor, cfg: RenderConfig = RenderConfig(),
                      occ_grid: torch.Tensor | None = None):
    """A training step's render of a flat batch of rays: as render_rays, but
    the samples are placed at the per-ray uniforms u_coarse [N, num_steps]
    and u_fine [N, upsample_steps] (in [0, 1)), and the outputs carry
    gradients to the model's parameters."""
    return _render(model, rays_o, rays_d, direction_norms, cfg, occ_grid,
                   u_coarse, u_fine)


@torch.no_grad()
def render_rays_early_stop(model, rays_o, rays_d, direction_norms,
                           cfg: RenderConfig = RenderConfig(), occ_grid=None,
                           valid: torch.Tensor | None = None):
    """Two-stage early-termination render of one ray batch.

    Stage 1 renders every ray with cfg.stage1_steps samples and no fine
    pass. The top refine_fraction rays by residual t_rem = 1 - accumulated
    mass re-render at the full budget; those still above term_threshold
    overwrite their stage-1 result. valid=False lanes (padding) score -inf
    and never take a refine slot.
    """
    n = rays_o.shape[0]
    cfg_a = replace(cfg, num_steps=cfg.stage1_steps, upsample_steps=0,
                    early_stop=False)
    out_a = render_rays(model, rays_o, rays_d, direction_norms, cfg_a,
                        occ_grid)
    t_rem = 1.0 - out_a["semantics"].sum(dim=-1)
    if valid is not None:
        t_rem = torch.where(valid, t_rem, torch.full_like(t_rem,
                                                          float("-inf")))
    k = max(1, int(round(n * cfg.refine_fraction)))
    inds = torch.topk(t_rem, k).indices
    cfg_b = replace(cfg, early_stop=False)
    out_b = render_rays(model, rays_o[inds], rays_d[inds],
                        direction_norms[inds], cfg_b, occ_grid)
    alive = t_rem[inds] > cfg.term_threshold
    out = {}
    for name, a in out_a.items():
        b = out_b[name]
        sel = alive.reshape(alive.shape + (1,) * (b.ndim - 1))
        a[inds] = torch.where(sel, b, a[inds])  # out_a's tensors are ours
        out[name] = a
    return out


@torch.no_grad()
def render_rays_staged(model, rays_o, rays_d, direction_norms,
                       cfg: RenderConfig = RenderConfig(), occ_grid=None):
    """Full-frame render: a loop over max_ray_batch-ray chunks. The rays are
    padded to a whole chunk (origin 0, direction +z, norm 1, valid False)
    so every chunk has the same shapes."""
    n = rays_o.shape[0]
    chunk = cfg.max_ray_batch
    n_pad = (-n) % chunk
    dev = rays_o.device
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    if n_pad:
        unit_z = torch.tensor([[0.0, 0.0, 1.0]], dtype=rays_d.dtype,
                              device=dev).expand(n_pad, 3)
        rays_o = torch.cat([rays_o, rays_o.new_zeros((n_pad, 3))])
        rays_d = torch.cat([rays_d, unit_z])
        direction_norms = torch.cat([direction_norms,
                                     direction_norms.new_ones((n_pad,))])
        valid = torch.cat([valid, valid.new_zeros((n_pad,))])
    outs = []
    for s in range(0, n + n_pad, chunk):
        o = rays_o[s:s + chunk]
        d = rays_d[s:s + chunk]
        nrm = direction_norms[s:s + chunk]
        if cfg.early_stop:
            outs.append(render_rays_early_stop(model, o, d, nrm, cfg,
                                               occ_grid, valid[s:s + chunk]))
        else:
            outs.append(render_rays(model, o, d, nrm, cfg, occ_grid))
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}


def normalize_semantics(semantics: torch.Tensor):
    """Renormalize accumulated semantic mass to a distribution; rays with no
    mass become uniform and are flagged invalid."""
    total = semantics.sum(dim=-1, keepdim=True)
    invalid = total[..., 0] == 0
    sem = torch.where(invalid[..., None], torch.ones_like(semantics),
                      semantics)
    return sem / sem.sum(dim=-1, keepdim=True), invalid
