"""Alpha compositing along rays (counterpart of
ucsa_neural_rendering_tpu/ops/compositing.py).

`composite_fwd` is the wrapper of the `composite_fwd` CUDA kernel
(csrc/composite_fwd.cu), which computes the weights and the masked sums in
one pass; `composite_fwd_plain` is the same function in plain PyTorch
(`composite(composite_weights(...))`), taken for CPU tensors.
"""

import torch

from .. import kernels


def composite_weights(z_vals: torch.Tensor, sigmas: torch.Tensor,
                      density_scale: float = 1.0) -> torch.Tensor:
    """[N, T] z-values + densities → compositing weights [N, T]:
    alpha_i = 1 - exp(-delta_i·scale·sigma_i) with delta_last = 1e10,
    T_i = prod_{j<i} (1 - alpha_j + 1e-15), weight_i = alpha_i·T_i."""
    z_vals = z_vals.float()
    sigmas = sigmas.float()
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)],
                       dim=-1)
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    trans = torch.cumprod(1.0 - alphas + 1e-15, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)  # exclusive
    return alphas * trans


def composite(weights: torch.Tensor, z_vals: torch.Tensor, rgbs: torch.Tensor,
              semantics: torch.Tensor, direction_norms: torch.Tensor,
              weight_mask_threshold: float = 1e-4):
    """Weighted reduction to rgb [N,3], semantics [N,C], z-depth [N]
    (sum(w·z) / ||unnormalized pixel direction||); weights at or below the
    threshold are zeroed."""
    w = torch.where(weights > weight_mask_threshold, weights,
                    torch.zeros_like(weights))
    image = (w[..., None] * rgbs.float()).sum(dim=-2)
    sem = (w[..., None] * semantics.float()).sum(dim=-2)
    depth = (w * z_vals).sum(dim=-1) / direction_norms
    return image, sem, depth


def composite_fwd_plain(z_vals, sigmas, rgbs, semantics, direction_norms,
                        density_scale: float = 1.0,
                        weight_mask_threshold: float = 1e-4):
    """Plain version of the composite_fwd kernel."""
    weights = composite_weights(z_vals, sigmas, density_scale)
    return composite(weights, z_vals, rgbs, semantics, direction_norms,
                     weight_mask_threshold)


def composite_fwd(z_vals: torch.Tensor, sigmas: torch.Tensor,
                  rgbs: torch.Tensor, semantics: torch.Tensor,
                  direction_norms: torch.Tensor, density_scale: float = 1.0,
                  weight_mask_threshold: float = 1e-4):
    """z [N,T], sigma [N,T], rgb [N,T,3], semantics [N,T,C] (all f32),
    direction_norms [N] → (image [N,3], semantics [N,C], depth [N]).
    CUDA tensors launch composite_fwd; CPU tensors take the plain version."""
    if not z_vals.is_cuda:
        return composite_fwd_plain(z_vals, sigmas, rgbs, semantics,
                                   direction_norms, density_scale,
                                   weight_mask_threshold)
    n, t = z_vals.shape
    c = semantics.shape[-1]
    dev = z_vals.device
    f32 = torch.float32
    kernels.check(z_vals, "z_vals", f32, (n, t))
    kernels.check(sigmas, "sigmas", f32, (n, t), dev)
    kernels.check(rgbs, "rgbs", f32, (n, t, 3), dev)
    kernels.check(semantics, "semantics", f32, (n, t, c), dev)
    kernels.check(direction_norms, "direction_norms", f32, (n,), dev)
    if t > 1024:
        raise ValueError(f"composite_fwd takes at most 1024 samples, got {t}")
    image = torch.empty((n, 3), dtype=f32, device=dev)
    sem = torch.empty((n, c), dtype=f32, device=dev)
    depth = torch.empty((n,), dtype=f32, device=dev)
    if n:
        kernels.launch("composite_fwd", z_vals, sigmas, rgbs, semantics,
                       direction_norms, image, sem, depth, n, t, c,
                       float(density_scale), float(weight_mask_threshold))
    return image, sem, depth
