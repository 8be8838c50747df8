"""Multi-resolution hash-grid encoding (counterpart of
ucsa_neural_rendering_tpu/models/hash_encoding.py: HashGridSpec, make_spec,
ngp_per_level_scale, _level_indices, hash_encode, the sampled-corner
machinery and the two table backwards).

Three CUDA kernels, each with its wrapper and plain PyTorch version here
(on a CUDA tensor the wrapper launches the kernel, on a CPU tensor it takes
`<name>_plain`):
  hash_encode          csrc/hash_encode_fwd.cu      exact 8-corner bf16 blend
                                                    (`_hash_encode_raw`)
  hash_encode_bwd      csrc/hash_encode_bwd.cu      f32 table gradient, one
                                                    sampled corner per (point,
                                                    level) or all 8 weighted
                                                    (`_hesg_bwd` / `_hef_bwd`)
  hash_encode_sampled  csrc/hash_encode_sampled.cu  one sampled corner's bf16
                                                    row (`hash_encode_sampled`)
The forwards gather from the bf16 copy of the f32 table; the backward
accumulates into a gradient of the f32 table, which is the autograd input.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..utils.device import resolve_device

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridSpec:
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.5
    # derived, filled by make_spec
    resolutions: tuple = field(default=())
    offsets: tuple = field(default=())
    sizes: tuple = field(default=())
    hashed: tuple = field(default=())

    @property
    def table_size(self) -> int:
        return self.offsets[-1] + self.sizes[-1]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def make_spec(n_levels=16, n_features=2, log2_hashmap_size=19,
              base_resolution=16, per_level_scale=1.5) -> HashGridSpec:
    max_entries = 2 ** log2_hashmap_size
    resolutions, offsets, sizes, hashed = [], [], [], []
    off = 0
    for lvl in range(n_levels):
        v = base_resolution * per_level_scale ** lvl
        # tolerate fp error when the scale is an exact power (e.g. 8192)
        res = int(round(v)) if abs(v - round(v)) < 1e-4 else int(math.floor(v))
        dense = (res + 1) ** 3
        if dense <= max_entries:
            size, is_hashed = dense, False
        else:
            size, is_hashed = max_entries, True
        size = -(-size // 8) * 8  # align like tcnn
        resolutions.append(res)
        offsets.append(off)
        sizes.append(size)
        hashed.append(is_hashed)
        off += size
    return HashGridSpec(n_levels, n_features, log2_hashmap_size,
                        base_resolution, per_level_scale,
                        tuple(resolutions), tuple(offsets), tuple(sizes),
                        tuple(hashed))


def ngp_per_level_scale(bound: float, n_levels: int = 16,
                        max_resolution_at_bound1: int = 2048,
                        base_resolution: int = 16) -> float:
    """per_level_scale = exp2(log2(2048*bound/16)/(L-1))."""
    return float(np.exp2(
        np.log2(max_resolution_at_bound1 * bound / base_resolution)
        / (n_levels - 1)))


_CORNERS = [[(c >> a) & 1 for a in range(3)] for c in range(8)]  # [8, 3]


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """[N, 3] fractional positions → [N, 8] f32 trilinear weights, the
    product over axes 0, 1, 2 of (frac if the corner's bit is set else
    1 - frac), multiplied in that order."""
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=frac.device)
    w = torch.ones((frac.shape[0], 8), dtype=torch.float32,
                   device=frac.device)
    for a in range(3):
        fa = frac[:, a:a + 1]
        w = w * torch.where(corners[None, :, a] == 1, fa, 1.0 - fa)
    return w


def _level_indices(x01: torch.Tensor, res: int, size: int, is_hashed: bool):
    """x01 [N, 3] in [0,1] → ([N, 8] int64 corner indices within the level,
    [N, 8] f32 trilinear weights). The uint32 hash arithmetic runs in int64
    masked to 32 bits."""
    pos = x01.float() * res  # the grid has res+1 vertices per axis
    grid = torch.floor(pos)
    frac = pos - grid
    grid = grid.to(torch.int64)
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=x01.device)
    cidx = (grid[:, None, :] + corners[None]).clamp_max(res)  # [N, 8, 3]
    return _hash_index(cidx[..., 0], cidx[..., 1], cidx[..., 2], res, size,
                       is_hashed), _corner_weights(frac)


def _hash_index(cx, cy, cz, res: int, size: int, is_hashed: bool):
    """Table index within a level of integer vertex coordinates (≤ res)."""
    if is_hashed:
        return ((cx * _PRIMES[0]) ^ ((cy * _PRIMES[1]) & _U32)
                ^ ((cz * _PRIMES[2]) & _U32)) % size
    stride = res + 1
    return (cz * stride + cy) * stride + cx


def _level_weights(x01: torch.Tensor, res: int) -> torch.Tensor:
    """[N, 3] → [N, 8] trilinear corner weights of one level."""
    pos = x01.float() * res
    return _corner_weights(pos - torch.floor(pos))


def _level_corner_index(x01: torch.Tensor, res: int, size: int,
                        is_hashed: bool, corner: torch.Tensor):
    """Table index within the level of ONE chosen corner per point;
    corner [N] in [0, 8)."""
    grid = torch.floor(x01.float() * res).to(torch.int64)
    c = corner.to(torch.int64)
    cx, cy, cz = ((grid[:, a] + ((c >> a) & 1)).clamp_max(res)
                  for a in range(3))
    return _hash_index(cx, cy, cz, res, size, is_hashed)


def _mul32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a · p) mod 2^32 for int64 a in [0, 2^32) and a uint32 constant p,
    in 16-bit halves of p so that no int64 product overflows."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _corner_uniform(x01: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Deterministic per-(point, level) uniform in [0, 1) from the bits of
    the f32 position: [N, 3] → [N, L] f32, bit-equal to the JAX package's
    uint32 hash with salt 0 (here in int64 masked to 32 bits)."""
    bits = x01.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    h = (_mul32(bits[:, 0], _PRIMES[1]) ^ _mul32(bits[:, 1], _PRIMES[2])
         ^ _mul32(bits[:, 2], 0x9E3779B9))
    lvl = _mul32(torch.arange(n_levels, dtype=torch.int64,
                              device=x01.device), 0x85EBCA6B)
    h = h[:, None] ^ lvl[None, :]
    h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def sampled_corner_indices(x01: torch.Tensor,
                           spec: "HashGridSpec") -> torch.Tensor:
    """Per (point, level) ONE corner drawn with probability equal to its
    trilinear weight (uniform from _corner_uniform) → its global table index,
    [N, L] int64. The cdf over the 8 weights is a sequential f32 sum, as the
    JAX package's cumsum: another order flips a corner whenever u lies
    within an ulp of a cdf value."""
    u = _corner_uniform(x01, spec.n_levels)
    idx_all = []
    for lvl in range(spec.n_levels):
        w = _level_weights(x01, spec.resolutions[lvl])
        acc = w[:, 0]
        cdf = [acc]
        for c in range(1, 8):
            acc = acc + w[:, c]
            cdf.append(acc)
        cdf = torch.stack(cdf, dim=-1)
        corner = (u[:, lvl, None] >= cdf).sum(-1).clamp(0, 7)
        idx = _level_corner_index(x01, spec.resolutions[lvl],
                                  spec.sizes[lvl], spec.hashed[lvl], corner)
        idx_all.append(idx + spec.offsets[lvl])
    return torch.stack(idx_all, dim=1)


def hash_encode_plain(table_bf16: torch.Tensor, x01: torch.Tensor,
                      spec: HashGridSpec) -> torch.Tensor:
    """Plain version of the hash_encode_fwd kernel.

    table_bf16 [T, F] bf16 (the bf16 copy of the f32 table), x01 [N, 3] f32
    → [N, L·F] bf16. Per (point, level): the 8 corner rows times their
    trilinear weights rounded to bf16 (each product exact in f32), summed in
    f32 over the corners in order and rounded to bf16 once — what XLA makes
    of the JAX package's bf16 multiply-and-sum."""
    n = x01.shape[0]
    feats = []
    for lvl in range(spec.n_levels):
        idx, w = _level_indices(x01, spec.resolutions[lvl], spec.sizes[lvl],
                                spec.hashed[lvl])
        rows = table_bf16[idx + spec.offsets[lvl]].float()       # [N, 8, F]
        prod = rows * w.to(torch.bfloat16).float()[..., None]
        acc = prod[:, 0]
        for c in range(1, 8):
            acc = acc + prod[:, c]
        feats.append(acc.to(torch.bfloat16))
    return torch.cat(feats, dim=1).reshape(n, spec.out_dim)


_META = {}
# the feature widths the kernel is instantiated for (the shipped 8 × 4 model
# and the default width)
_KERNEL_FEATURES = (2, 4)


def _level_meta(spec: HashGridSpec, device) -> torch.Tensor:
    """int32 [4, L] (resolution, offset, size, hashed) on the device, built
    once per (spec, device)."""
    key = (spec, str(device))
    if key not in _META:
        _META[key] = torch.tensor(
            [spec.resolutions, spec.offsets, spec.sizes,
             [int(h) for h in spec.hashed]], dtype=torch.int32,
            device=device)
    return _META[key]


def _check_kernel_args(name: str, x01: torch.Tensor, spec: HashGridSpec):
    if spec.n_features not in _KERNEL_FEATURES:
        raise ValueError(f"{name} is built for n_features in "
                         f"{_KERNEL_FEATURES}, got {spec.n_features}")
    kernels.check(x01, "x01", torch.float32, (x01.shape[0], 3))


def hash_encode(table_bf16: torch.Tensor, x01: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """table_bf16 [table_size, F] bf16, x01 [N, 3] f32 in [0, 1] →
    [N, L·F] bf16 features. CUDA tensors launch hash_encode_fwd; CPU tensors
    take hash_encode_plain."""
    if not x01.is_cuda:
        return hash_encode_plain(table_bf16, x01, spec)
    _check_kernel_args("hash_encode_fwd", x01, spec)
    if spec.n_levels > 32:
        raise ValueError(f"hash_encode_fwd takes at most 32 levels, got "
                         f"{spec.n_levels}")
    n = x01.shape[0]
    kernels.check(table_bf16, "table_bf16", torch.bfloat16,
                  (spec.table_size, spec.n_features), x01.device)
    out = torch.empty((n, spec.out_dim), dtype=torch.bfloat16,
                      device=x01.device)
    if n:
        kernels.launch("hash_encode_fwd", table_bf16, x01,
                       _level_meta(spec, x01.device), out, n, spec.n_levels,
                       spec.n_features)
    return out


def hash_encode_sampled_plain(table_bf16: torch.Tensor, x01: torch.Tensor,
                              spec: HashGridSpec) -> torch.Tensor:
    """Plain version of the hash_encode_sampled kernel: per (point, level)
    the bf16 row of the one corner sampled_corner_indices draws →
    [N, L·F] bf16."""
    idx = sampled_corner_indices(x01, spec)                    # [N, L]
    return table_bf16[idx.reshape(-1)].reshape(x01.shape[0], spec.out_dim)


def hash_encode_sampled(table_bf16: torch.Tensor, x01: torch.Tensor,
                        spec: HashGridSpec) -> torch.Tensor:
    """Single-corner forward of the occupancy probe (not differentiable):
    table_bf16 [T, F] bf16, x01 [N, 3] f32 → [N, L·F] bf16. CUDA tensors
    launch hash_encode_sampled; CPU tensors take the plain version."""
    if not x01.is_cuda:
        return hash_encode_sampled_plain(table_bf16, x01, spec)
    _check_kernel_args("hash_encode_sampled", x01, spec)
    n = x01.shape[0]
    kernels.check(table_bf16, "table_bf16", torch.bfloat16,
                  (spec.table_size, spec.n_features), x01.device)
    out = torch.empty((n, spec.out_dim), dtype=torch.bfloat16,
                      device=x01.device)
    if n:
        kernels.launch("hash_encode_sampled", table_bf16, x01,
                       _level_meta(spec, x01.device), out, n, spec.n_levels,
                       spec.n_features)
    return out


def hash_encode_bwd_plain(x01: torch.Tensor, g: torch.Tensor,
                          spec: HashGridSpec,
                          stochastic: bool) -> torch.Tensor:
    """Plain version of the hash_encode_bwd kernel: the gradient of the f32
    table [T, F] from the encode's cotangent g [N, L·F] (bf16, accumulated
    in f32). stochastic: each (point, level) cotangent lands whole on the
    one corner sampled_corner_indices draws (`_hesg_bwd`); else on all 8
    corners times their f32 trilinear weights (`_hef_bwd`)."""
    n, f = x01.shape[0], spec.n_features
    g = g.float().reshape(n, spec.n_levels, f)
    grad = torch.zeros((spec.table_size, f), dtype=torch.float32,
                       device=x01.device)
    if stochastic:
        idx = sampled_corner_indices(x01, spec)
        return grad.index_add_(0, idx.reshape(-1), g.reshape(-1, f))
    for lvl in range(spec.n_levels):
        idx, w = _level_indices(x01, spec.resolutions[lvl], spec.sizes[lvl],
                                spec.hashed[lvl])
        contrib = w[..., None] * g[:, lvl, None, :]               # [N, 8, F]
        grad.index_add_(0, (idx + spec.offsets[lvl]).reshape(-1),
                        contrib.reshape(-1, f))
    return grad


def hash_encode_bwd(x01: torch.Tensor, g: torch.Tensor, spec: HashGridSpec,
                    stochastic: bool) -> torch.Tensor:
    """x01 [N, 3] f32, g [N, L·F] bf16 → f32 table gradient [T, F], as in
    hash_encode_bwd_plain. CUDA tensors launch hash_encode_bwd (f32
    reductions: the last bits vary from run to run); CPU tensors take the
    plain version. The zeroed gradient is part of the call."""
    if not x01.is_cuda:
        return hash_encode_bwd_plain(x01, g, spec, stochastic)
    _check_kernel_args("hash_encode_bwd", x01, spec)
    if spec.n_levels > 32:
        raise ValueError(f"hash_encode_bwd takes at most 32 levels, got "
                         f"{spec.n_levels}")
    n = x01.shape[0]
    kernels.check(g, "g", torch.bfloat16, (n, spec.out_dim), x01.device)
    grad = torch.zeros((spec.table_size, spec.n_features),
                       dtype=torch.float32, device=x01.device)
    if n:
        kernels.launch("hash_encode_bwd", x01, g,
                       _level_meta(spec, x01.device), grad, n, spec.n_levels,
                       spec.n_features, int(bool(stochastic)))
    return grad


class _HashEncode(torch.autograd.Function):
    """The exact encode (hash_encode on the bf16 copy) whose backward is
    hash_encode_bwd into the gradient of the f32 table, the autograd input.
    No gradient reaches x01, as in the JAX package."""

    @staticmethod
    def forward(ctx, table, table_bf16, x01, spec, stochastic):
        ctx.save_for_backward(x01)
        ctx.spec, ctx.stochastic = spec, stochastic
        return hash_encode(table_bf16, x01, spec)

    @staticmethod
    def backward(ctx, g):
        (x01,) = ctx.saved_tensors
        grad = hash_encode_bwd(x01, g.to(torch.bfloat16).contiguous(),
                               ctx.spec, ctx.stochastic)
        return grad, None, None, None, None


class HashGridEncoding(nn.Module):
    """Owns the f32 hash table [table_size, F] (parameter `table`, the JAX
    package's `encoder/table`) and its bf16 copy, cast once per version of
    the table and reused by every encode until the table changes.

    stochastic_grad: the table gradient takes one corner per (point, level)
    drawn by its trilinear weight (unbiased, 8× fewer scatter rows), else
    all 8 weighted corners."""

    def __init__(self, spec: HashGridSpec, device="cuda",
                 generator: torch.Generator | None = None,
                 init_range: float = 1e-4, stochastic_grad: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.stochastic_grad = stochastic_grad
        table = torch.empty((spec.table_size, spec.n_features),
                            dtype=torch.float32)
        table.uniform_(-init_range, init_range, generator=generator)
        self.table = nn.Parameter(table.to(device))
        self._bf16_key = None
        self._bf16 = None

    def table_bf16(self) -> torch.Tensor:
        t = self.table
        key = (t.data_ptr(), t._version, t.device)
        if key != self._bf16_key:
            self._bf16 = t.detach().to(torch.bfloat16)
            self._bf16_key = key
        return self._bf16

    def forward(self, x01: torch.Tensor, probe: bool = False) -> torch.Tensor:
        """x01 [N, 3] in [0, 1] → [N, L·F] bf16. probe: the single-corner
        sampled encode of the occupancy refresh (no gradient); else the
        exact encode, differentiable in the table when grad is enabled."""
        if probe:
            return hash_encode_sampled(self.table_bf16(), x01, self.spec)
        return _HashEncode.apply(self.table, self.table_bf16(), x01,
                                 self.spec, self.stochastic_grad)
