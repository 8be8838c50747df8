"""Volumetric Semantic-NeRF render of a ray batch (counterpart of
ucsa_neural_rendering_tpu/ops/renderer.py).

  coarse: with an occupancy grid, occ_placement — AABB → grid candidates →
          inverse-CDF (binary occupancy or proposal placement); without
          one (the reference's dense program), stratified_placement —
          AABB → uniformly spaced z, jittered in a training step; then a
          density pass
  fine:   importance_resample — inverse-CDF from the detached coarse
          weights, stable merge → second density pass
  shade:  color / semantics MLPs, composite_rays (masked weighted sums)
  out:    rgb [N,3], semantic mass [N,C], z-depth [N]

Probe placement (RenderConfig.probe_placement, deterministic renders only)
replaces coarse and fine: num_probe samples placed by occ_placement
(binary, det) or, without a grid, stratified_placement; their densities
through the sampled-corner probe (density_probe); importance_resample of
num_steps samples from those weights; then one exact density pass at them,
shading and compositing (upsample_steps is not used).

`render_rays` is the deterministic render (det inverse-CDF positions, no
gradient); `render_rays_train` is a training step's render: the caller's
per-ray uniforms place the samples (the JAX package's keyed branch), and
the outputs carry gradients to the model's parameters.

On CUDA tensors the steps above run as the hand-written kernels
(hash_encode_fwd and mlp_fwd inside the density passes, hash_encode_sampled
in the probe, mlp_fwd for the color and semantics; composite_bwd, mlp_bwd
and hash_encode_bwd in the backward; a training step of a model with
stochastic_fwd True or "face" encodes with hash_encode_sampled or
hash_encode_face_fwd); on CPU tensors as their plain PyTorch versions (on
the card too inside `kernels.plain_versions()`).

Cell-packed tables (`packed=`, models/packed_table.py): the renders and
probes encode through the PackedTable they are given, which the trainers
build where packing_enabled says (on the card: fp8 rows at
packed_max_entries for the renders, bf16 rows at train_packed_max_entries
repacked in every training step); the encodes then launch
hash_encode_packed_fwd in place of hash_encode_fwd, hash_encode_sampled in
the probe and, under stochastic_fwd "face" or "fine", in place of
hash_encode_face_fwd or the exact encode.

Ray sharding (`mesh=`, a parallel.Mesh; JAX `_shard_rays`, `:134-181`): a
ray batch whose size the world size divides is split into the ranks'
contiguous blocks, each rank rendering its own. The deterministic renders
gather the blocks, so every rank returns what one rank returns for the
whole batch; early stop ranks the whole chunk's residual transmittance
(its stage 1 is gathered before the selection). A training render returns
this rank's block, which the losses reduce over the ranks
(train.nerf_trainer.nerf_losses). A batch the world size does not divide
renders whole on every rank, as JAX skips the sharding constraint there.
"""

import os
from dataclasses import dataclass, replace

import torch

from ..parallel.mesh import unshard
from .compositing import composite_rays
from .placement import (importance_resample, occ_placement,
                        stratified_placement)


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
    # cell-packed render tables (models/packed_table.py): the levels whose
    # res³ cells fit this budget read one row of their cell's 8 corners;
    # 0 turns it off; stored as "fp8" (e4m3) or "bf16" (the exact relayout)
    packed_max_entries: int = 8 * 1024 * 1024
    packed_dtype: str = "fp8"
    # probe placement (deterministic renders only): num_probe samples
    # through the sampled-corner probe place the num_steps exact samples by
    # inverse CDF; upsample_steps is not used
    probe_placement: bool = False
    num_probe: int = 16
    # graded grid-density alphas instead of binary occupancy weights
    proposal_placement: bool = False
    # training-step packing: bf16 rows of the levels within this budget,
    # repacked in every step, carry the step's forward (the table gradient
    # is the unpacked one's); 0 turns it off
    train_packed_max_entries: int = 2 ** 21


def packing_enabled(device, train: bool = False) -> bool:
    """Whether the cell-packed tables engage on `device`: on a CUDA device,
    where the JAX package packs on its TPU; not on the CPU, except that a
    training step's packing engages there under UCSA_TRAIN_PACKED_ON_CPU=1,
    the JAX package's own switch for its CPU equality tests."""
    if torch.device(device).type == "cuda":
        return True
    return train and os.environ.get("UCSA_TRAIN_PACKED_ON_CPU") == "1"


def _clip_to_aabb(xyz: torch.Tensor, bound: float) -> torch.Tensor:
    return xyz.clamp(-bound, bound)


def _points(rays_o, rays_d, z, bound):
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return _clip_to_aabb(xyz, bound).reshape(-1, 3)


def _probe_z(model, rays_o, rays_d, cfg, occ_grid, packed=None):
    """Probe placement's sample positions [N, num_steps], sorted: num_probe
    probe samples (binary occupancy placement, or stratified without a
    grid), their sampled-corner densities, and the det inverse CDF of their
    weights."""
    bound = model.bound
    if occ_grid is None:
        z_probe = stratified_placement(rays_o, rays_d, bound, cfg.num_probe,
                                       cfg.min_near)
    else:
        z_probe = occ_placement(rays_o, rays_d, occ_grid, bound,
                                cfg.num_probe, cfg.occ_candidates,
                                cfg.min_near, False, cfg.occ_floor,
                                cfg.occ_density_threshold, cfg.density_scale)
    pts = _points(rays_o, rays_d, z_probe, bound)
    sigma = model.density_probe(pts, packed)
    new_z = importance_resample(z_probe, sigma.reshape(z_probe.shape),
                                cfg.num_steps, cfg.density_scale)[0]
    # the kernel's rows come sorted; the plain version's are in u order
    return torch.sort(new_z, dim=-1).values


def _render(model, rays_o, rays_d, direction_norms, cfg, occ_grid,
            u_coarse=None, u_fine=None, train=False, packed=None):
    bound = model.bound
    n = rays_o.shape[0]

    # --- coarse pass ---
    upsample = cfg.upsample_steps
    if cfg.probe_placement and not train:
        z_vals = _probe_z(model, rays_o, rays_d, cfg, occ_grid, packed)
        upsample = 0
    elif occ_grid is None:
        # the dense program: u_coarse, when given, is the stratified jitter
        z_vals = stratified_placement(rays_o, rays_d, bound, cfg.num_steps,
                                      cfg.min_near, u_coarse)
    else:
        z_vals = occ_placement(rays_o, rays_d, occ_grid, bound,
                               cfg.num_steps, cfg.occ_candidates,
                               cfg.min_near, cfg.proposal_placement,
                               cfg.occ_floor, cfg.occ_density_threshold,
                               cfg.density_scale, u_coarse)
    # train: a training step's density calls, where the model's
    # stochastic_fwd encoders apply (the JAX package's is_train)
    sigma, geo = model.density(_points(rays_o, rays_d, z_vals, bound),
                               train, packed)
    sigma = sigma.reshape(n, cfg.num_steps)
    geo = geo.reshape(n, cfg.num_steps, -1)

    # --- fine pass: importance-resample from the detached coarse weights ---
    if upsample > 0:
        new_z, z_vals, order = importance_resample(
            z_vals, sigma.detach(), upsample, cfg.density_scale, u_fine)
        new_sigma, new_geo = model.density(
            _points(rays_o, rays_d, new_z, bound), train, packed)
        sigma = torch.take_along_dim(
            torch.cat([sigma, new_sigma.reshape(n, -1)], dim=-1), order,
            dim=-1)
        geo = torch.take_along_dim(
            torch.cat([geo, new_geo.reshape(n, upsample, -1)], dim=1),
            order[..., None], dim=1)

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
                occ_grid: torch.Tensor | None = None, packed=None, mesh=None):
    """Render a flat batch of rays deterministically.

    rays_o, rays_d: [N, 3] origins / unit directions; direction_norms: [N]
    norms of the unnormalized pixel directions; occ_grid: [r, r, r] density
    grid, or None for the dense program; packed: the model's PackedTable
    (models/packed_table.py) for its density calls, or None; mesh: the
    rays shard over its ranks and the outputs are gathered (module
    docstring).
    Returns dict image [N,3], semantics [N,C] (unnormalized mass), depth [N].
    """
    sl = None if mesh is None else mesh.block(rays_o.shape[0])
    if sl is None:
        return _render(model, rays_o, rays_d, direction_norms, cfg, occ_grid,
                       packed=packed)
    out = _render(model, rays_o[sl], rays_d[sl], direction_norms[sl], cfg,
                  occ_grid, packed=packed)
    return {k: unshard(v, mesh) for k, v in out.items()}


def render_rays_train(model, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      direction_norms: torch.Tensor, u_coarse: torch.Tensor,
                      u_fine: torch.Tensor, cfg: RenderConfig = RenderConfig(),
                      occ_grid: torch.Tensor | None = None, packed=None,
                      mesh=None):
    """A training step's render of a flat batch of rays: as render_rays, but
    the samples are placed at the per-ray uniforms u_coarse [N, num_steps]
    (without a grid: the stratified jitter) and u_fine [N, upsample_steps]
    (in [0, 1)), the density calls are training calls (the model's
    stochastic_fwd encoders, through the step's PackedTable when given),
    and the outputs carry gradients to the model's parameters (none to the
    packed table). probe_placement does not apply here, as in the JAX
    package. Under a mesh the outputs are this rank's block of the rays,
    mesh.block(N) (all N where that is None)."""
    sl = None if mesh is None else mesh.block(rays_o.shape[0])
    if sl is not None:
        rays_o, rays_d, direction_norms, u_coarse, u_fine = (
            t[sl] for t in (rays_o, rays_d, direction_norms, u_coarse,
                            u_fine))
    return _render(model, rays_o, rays_d, direction_norms, cfg, occ_grid,
                   u_coarse, u_fine, train=True, packed=packed)


@torch.no_grad()
def render_rays_early_stop(model, rays_o, rays_d, direction_norms,
                           cfg: RenderConfig = RenderConfig(), occ_grid=None,
                           valid: torch.Tensor | None = None, packed=None,
                           mesh=None):
    """Two-stage early-termination render of one ray batch.

    Stage 1 renders every ray with cfg.stage1_steps samples and no fine
    pass. The top refine_fraction rays by residual t_rem = 1 - accumulated
    mass re-render at the full budget; those still above term_threshold
    overwrite their stage-1 result. valid=False lanes (padding) score -inf
    and never take a refine slot. Both stages keep cfg's placement (probe
    placement too); occ_grid may be None (the dense program). Under a mesh
    both stages shard their rays and gather them, so the selection ranks
    the whole batch on every rank.
    """
    n = rays_o.shape[0]
    cfg_a = replace(cfg, num_steps=cfg.stage1_steps, upsample_steps=0,
                    early_stop=False)
    out_a = render_rays(model, rays_o, rays_d, direction_norms, cfg_a,
                        occ_grid, packed, mesh)
    t_rem = 1.0 - out_a["semantics"].sum(dim=-1)
    if valid is not None:
        t_rem = torch.where(valid, t_rem, torch.full_like(t_rem,
                                                          float("-inf")))
    k = max(1, int(round(n * cfg.refine_fraction)))
    inds = torch.topk(t_rem, k).indices
    cfg_b = replace(cfg, early_stop=False)
    out_b = render_rays(model, rays_o[inds], rays_d[inds],
                        direction_norms[inds], cfg_b, occ_grid, packed,
                        mesh)
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
                       cfg: RenderConfig = RenderConfig(), occ_grid=None,
                       packed=None, mesh=None):
    """Full-frame render: a loop over max_ray_batch-ray chunks, each
    through `packed` when given and sharded over `mesh` when given. The
    rays are padded to a whole chunk (origin 0, direction +z, norm 1,
    valid False) so every chunk has the same shapes."""
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
                                               occ_grid, valid[s:s + chunk],
                                               packed, mesh))
        else:
            outs.append(render_rays(model, o, d, nrm, cfg, occ_grid,
                                    packed, mesh))
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}


def normalize_semantics(semantics: torch.Tensor):
    """Renormalize accumulated semantic mass to a distribution; rays with no
    mass become uniform and are flagged invalid."""
    total = semantics.sum(dim=-1, keepdim=True)
    invalid = total[..., 0] == 0
    sem = torch.where(invalid[..., None], torch.ones_like(semantics),
                      semantics)
    return sem / sem.sum(dim=-1, keepdim=True), invalid
