"""Alpha compositing along rays (counterpart of
ucsa_neural_rendering_tpu/ops/compositing.py).

`composite_fwd` is the wrapper of the `composite_fwd` CUDA kernel
(csrc/composite_fwd.cu), which computes the weights and the masked sums in
one pass; `composite_fwd_plain` is the same function in plain PyTorch
(`composite(composite_weights(...))`), taken for CPU tensors.
`composite_bwd` wraps the `composite_bwd` kernel (csrc/composite_bwd.cu),
its vector-Jacobian product; `composite_bwd_plain` is autograd through
`composite_fwd_plain`. `composite_rays` is the differentiable composite of
the render and training paths: forward composite_fwd, backward
composite_bwd.
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
    threshold are zeroed. The semantics sum takes DETACHED weights, as the
    JAX package's does: the semantics loss trains the semantics head, not
    the density field."""
    w = torch.where(weights > weight_mask_threshold, weights,
                    torch.zeros_like(weights))
    image = (w[..., None] * rgbs.float()).sum(dim=-2)
    sem = (w.detach()[..., None] * semantics.float()).sum(dim=-2)
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


def composite_bwd_plain(z_vals, sigmas, rgbs, semantics, direction_norms,
                        g_image, g_sem, g_depth, density_scale: float = 1.0,
                        weight_mask_threshold: float = 1e-4):
    """Plain version of the composite_bwd kernel: autograd through
    composite_fwd_plain → (d_sigma [N,T], d_rgb [N,T,3], d_sem [N,T,C])."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (sigmas, rgbs,
                                                        semantics)]
        outs = composite_fwd_plain(z_vals, *inputs, direction_norms,
                                   density_scale, weight_mask_threshold)
        return torch.autograd.grad(outs, inputs, (g_image, g_sem, g_depth))


def composite_bwd(z_vals: torch.Tensor, sigmas: torch.Tensor,
                  rgbs: torch.Tensor, semantics: torch.Tensor,
                  direction_norms: torch.Tensor, g_image: torch.Tensor,
                  g_sem: torch.Tensor, g_depth: torch.Tensor,
                  density_scale: float = 1.0,
                  weight_mask_threshold: float = 1e-4):
    """The VJP of composite_fwd: inputs as composite_fwd's plus the
    cotangents g_image [N,3], g_sem [N,C], g_depth [N] (f32) →
    (d_sigma [N,T], d_rgb [N,T,3], d_sem [N,T,C]). No gradient reaches z or
    the norms. CUDA tensors launch composite_bwd (which reads semantics only
    for its shape); CPU tensors take the plain version."""
    if not z_vals.is_cuda:
        return composite_bwd_plain(z_vals, sigmas, rgbs, semantics,
                                   direction_norms, g_image, g_sem, g_depth,
                                   density_scale, weight_mask_threshold)
    n, t = z_vals.shape
    c = semantics.shape[-1]
    dev = z_vals.device
    f32 = torch.float32
    kernels.check(z_vals, "z_vals", f32, (n, t))
    kernels.check(sigmas, "sigmas", f32, (n, t), dev)
    kernels.check(rgbs, "rgbs", f32, (n, t, 3), dev)
    kernels.check(semantics, "semantics", f32, (n, t, c), dev)
    kernels.check(direction_norms, "direction_norms", f32, (n,), dev)
    kernels.check(g_image, "g_image", f32, (n, 3), dev)
    kernels.check(g_sem, "g_sem", f32, (n, c), dev)
    kernels.check(g_depth, "g_depth", f32, (n,), dev)
    if t > 1024:
        raise ValueError(f"composite_bwd takes at most 1024 samples, got {t}")
    d_sigma = torch.empty((n, t), dtype=f32, device=dev)
    d_rgb = torch.empty((n, t, 3), dtype=f32, device=dev)
    d_sem = torch.empty((n, t, c), dtype=f32, device=dev)
    if n:
        kernels.launch("composite_bwd", z_vals, sigmas, rgbs,
                       direction_norms, g_image, g_sem, g_depth, d_sigma,
                       d_rgb, d_sem, n, t, c, float(density_scale),
                       float(weight_mask_threshold))
    return d_sigma, d_rgb, d_sem


class _CompositeRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_vals, sigmas, rgbs, semantics, direction_norms,
                density_scale, weight_mask_threshold):
        ctx.save_for_backward(z_vals, sigmas, rgbs, semantics,
                              direction_norms)
        ctx.args = (density_scale, weight_mask_threshold)
        return composite_fwd(z_vals, sigmas, rgbs, semantics,
                             direction_norms, density_scale,
                             weight_mask_threshold)

    @staticmethod
    def backward(ctx, g_image, g_sem, g_depth):
        grads = composite_bwd(*ctx.saved_tensors, g_image.contiguous(),
                              g_sem.contiguous(), g_depth.contiguous(),
                              *ctx.args)
        return None, *grads, None, None, None


def composite_rays(z_vals: torch.Tensor, sigmas: torch.Tensor,
                   rgbs: torch.Tensor, semantics: torch.Tensor,
                   direction_norms: torch.Tensor, density_scale: float = 1.0,
                   weight_mask_threshold: float = 1e-4):
    """composite_fwd, differentiable in sigmas, rgbs and semantics (the
    semantics sum with detached weights) through composite_bwd."""
    return _CompositeRays.apply(z_vals, sigmas, rgbs, semantics,
                                direction_norms, density_scale,
                                weight_mask_threshold)
