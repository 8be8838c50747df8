"""Ray sampling: uniformly spaced z-values + inverse-CDF importance sampling
(counterpart of ucsa_neural_rendering_tpu/ops/sampling.py). The training
draws come in as per-ray uniforms `u` that the caller draws from its
torch.Generator (the JAX package draws them from a key); without `u` the
placement is the deterministic one. The jittered `stratified_samples` of the
dense no-grid path is not ported.

The plain versions here are the reference and the CPU path of the
`occ_placement` and `importance_resample` kernels (ops/placement.py).
"""

import numpy as np
import torch


def _linspace_np(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num, dtype=float32) as XLA computes it on
    the CPU: f32 start*(1-step) + stop*step with step = iota * (1/div), the
    endpoint exact. Bit-equal for linspace(0, 1, num); for other ends XLA's
    fusion choices move single values by an ulp or two."""
    s, e = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([s], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1) / np.float32(div))
    out = s * (np.float32(1) - step) + e * step
    return np.concatenate([out, [e]]).astype(np.float32)


_DEVICE_LINSPACE = {}


def linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """[num] float32 on `device`, the same values as the JAX package's
    jnp.linspace (torch.linspace differs from it in the last ulp). Built
    once per (start, stop, num, device): a host-to-card copy inside the
    render loop would stall it. Callers must not write to it."""
    key = (float(start), float(stop), int(num), str(device))
    if key not in _DEVICE_LINSPACE:
        _DEVICE_LINSPACE[key] = torch.from_numpy(
            _linspace_np(*key[:3])).to(device)
    return _DEVICE_LINSPACE[key]


def det_u(n_samples: int, device) -> torch.Tensor:
    """The det inverse-CDF positions linspace(0.5/S, 1-0.5/S, S)."""
    return linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, device)


def stratified_samples(nears: torch.Tensor, fars: torch.Tensor,
                       num_steps: int) -> torch.Tensor:
    """[N] near/far → [N, T] uniformly spaced z-values (no jitter)."""
    t = linspace(0.0, 1.0, num_steps, nears.device)
    n = nears[..., None]
    return n + (fars[..., None] - n) * t


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples positions per ray.

    bins: [N, T] bin positions; weights: [N, T-1] unnormalized bin weights;
    u: [N, n_samples] uniforms in [0, 1) (the keyed branch), or None for
    the det positions linspace(0.5/S, 1-0.5/S, S). Keeps the 1e-5 weight
    floor, searchsorted side="right" and the denom < 1e-5 guard of the
    reference. Returns [N, n_samples], in the order of u.
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, T]
    if u is None:
        u = det_u(n_samples, cdf.device).expand(
            cdf.shape[:-1] + (n_samples,)).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, below.clamp_max(last))
    bins_a = torch.gather(bins, -1, above.clamp_max(last))
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
