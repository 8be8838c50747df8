"""Multi-resolution hash-grid encoding, forward (counterpart of
ucsa_neural_rendering_tpu/models/hash_encoding.py: HashGridSpec, make_spec,
ngp_per_level_scale, _level_indices, hash_encode).

`hash_encode` is the wrapper of the `hash_encode_fwd` CUDA kernel
(csrc/hash_encode_fwd.cu): on a CUDA tensor it launches the kernel, on a CPU
tensor it takes `hash_encode_plain`, the plain PyTorch version of the same
function. Both gather from the bf16 copy of the f32 table and blend in bf16
like the JAX package's exact encode (`_hash_encode_raw`).
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from .. import kernels

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
    if is_hashed:
        idx = ((cidx[..., 0] * _PRIMES[0])
               ^ ((cidx[..., 1] * _PRIMES[1]) & _U32)
               ^ ((cidx[..., 2] * _PRIMES[2]) & _U32)) % size
    else:
        stride = res + 1
        idx = (cidx[..., 2] * stride + cidx[..., 1]) * stride + cidx[..., 0]
    # weight = prod over axes 0, 1, 2 of (frac if corner bit else 1 - frac)
    w = torch.ones((x01.shape[0], 8), dtype=torch.float32, device=x01.device)
    for a in range(3):
        fa = frac[:, a:a + 1]
        w = w * torch.where(corners[None, :, a] == 1, fa, 1.0 - fa)
    return idx, w


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


def hash_encode(table_bf16: torch.Tensor, x01: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """table_bf16 [table_size, F] bf16, x01 [N, 3] f32 in [0, 1] →
    [N, L·F] bf16 features. CUDA tensors launch hash_encode_fwd; CPU tensors
    take hash_encode_plain."""
    if not x01.is_cuda:
        return hash_encode_plain(table_bf16, x01, spec)
    if spec.n_features not in _KERNEL_FEATURES:
        raise ValueError(f"hash_encode_fwd is built for n_features in "
                         f"{_KERNEL_FEATURES}, got {spec.n_features}")
    n = x01.shape[0]
    kernels.check(x01, "x01", torch.float32, (n, 3))
    kernels.check(table_bf16, "table_bf16", torch.bfloat16,
                  (spec.table_size, spec.n_features), x01.device)
    out = torch.empty((n, spec.out_dim), dtype=torch.bfloat16,
                      device=x01.device)
    if n:
        kernels.launch("hash_encode_fwd", table_bf16, x01,
                       _level_meta(spec, x01.device), out, n, spec.n_levels,
                       spec.n_features)
    return out


class HashGridEncoding(nn.Module):
    """Owns the f32 hash table [table_size, F] (parameter `table`, the JAX
    package's `encoder/table`) and its bf16 copy, cast once per version of
    the table and reused by every encode until the table changes."""

    def __init__(self, spec: HashGridSpec, device="cpu",
                 generator: torch.Generator | None = None,
                 init_range: float = 1e-4):
        super().__init__()
        self.spec = spec
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

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """x01 [N, 3] in [0, 1] → [N, L·F] bf16."""
        return hash_encode(self.table_bf16(), x01, self.spec)
