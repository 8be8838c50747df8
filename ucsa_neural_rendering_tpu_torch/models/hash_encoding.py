"""Multi-resolution hash-grid encoding (counterpart of
ucsa_neural_rendering_tpu/models/hash_encoding.py: HashGridSpec, make_spec,
ngp_per_level_scale, _level_indices, hash_encode, the sampled-corner
machinery and the two table backwards).

Four CUDA kernels, each with its wrapper and plain PyTorch version here
(on a CUDA tensor the wrapper launches the kernel, on a CPU tensor it takes
`<name>_plain`):
  hash_encode          csrc/hash_encode_fwd.cu      exact 8-corner bf16 blend
                                                    (`_hash_encode_raw`)
  hash_encode_bwd      csrc/hash_encode_bwd.cu      f32 table gradient, one
                                                    sampled corner per (point,
                                                    level), all 8 weighted or
                                                    one corner of the forward's
                                                    face (`_hesg_bwd` /
                                                    `_hef_bwd` / `_hesface_bwd`)
  hash_encode_sampled  csrc/hash_encode_sampled.cu  one sampled corner's bf16
                                                    row (`hash_encode_sampled`)
  hash_encode_face     csrc/hash_encode_face_fwd.cu the sampled face's bilinear
                                                    bf16 blend
                                                    (`hash_encode_face_sampled`)
The forwards gather from the bf16 copy of the f32 table; the backward
accumulates into a gradient of the f32 table, which is the autograd input.
The stochastic training encoders (`stochastic_fwd=True`, "face" and, with a
packed table, "fine", K9) pair a sampled forward with the backward that
scatters to rows it read; the packed training encoders (K8) read a packed
table in the forward (models/packed_table.py's hash_encode_packed) and give
the table the unpacked backward's gradient.
"""

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..utils.device import resolve_device

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# the face estimator's salts of its two exact axes' draws
_FACE_SALT_E1 = 0x7F4A7C15
_FACE_SALT_E2 = 0x94D049BB


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


def _corner_uniform(x01: torch.Tensor, n_levels: int,
                    salt: int = 0) -> torch.Tensor:
    """Deterministic per-(point, level) uniform in [0, 1) from the bits of
    the f32 position: [N, 3] → [N, L] f32, bit-equal to the JAX package's
    uint32 hash (here in int64 masked to 32 bits). `salt` is XORed in
    before the level mix: 0 for the corner draw and the face's sampled
    axis, _FACE_SALT_E1 / _FACE_SALT_E2 for the face backward's exact
    axes."""
    bits = x01.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    h = (_mul32(bits[:, 0], _PRIMES[1]) ^ _mul32(bits[:, 1], _PRIMES[2])
         ^ _mul32(bits[:, 2], 0x9E3779B9) ^ salt)
    lvl = _mul32(torch.arange(n_levels, dtype=torch.int64,
                              device=x01.device), 0x85EBCA6B)
    h = h[:, None] ^ lvl[None, :]
    h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def sampled_corner_indices(x01: torch.Tensor, spec: "HashGridSpec",
                           levels: range | None = None) -> torch.Tensor:
    """Per (point, level) ONE corner drawn with probability equal to its
    trilinear weight (uniform from _corner_uniform) → its global table index,
    [N, |levels|] int64 (levels: all by default). Each level draws its own
    uniform column by its absolute level number, so a subset of the levels
    draws what the whole would at those levels. The cdf over the 8 weights
    is a sequential f32 sum, as the JAX package's cumsum: another order
    flips a corner whenever u lies within an ulp of a cdf value."""
    u = _corner_uniform(x01, spec.n_levels)
    idx_all = []
    for lvl in (range(spec.n_levels) if levels is None else levels):
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


def _level_face_axes(x01: torch.Tensor, res: int):
    """Per point at one level: the sampled axis a (argmax |frac - 0.5|, the
    first of tied axes, as jnp.argmax and torch.argmax take it), the exact
    axes e1 = (a + 1) % 3 and e2 = (a + 2) % 3, and the fracs of a, e1, e2
    → (a, e1, e2, fa, f1, f2), each [N]."""
    pos = x01.float() * res
    frac = pos - torch.floor(pos)
    a = torch.argmax((frac - 0.5).abs(), dim=-1)
    e1, e2 = (a + 1) % 3, (a + 2) % 3

    def sel(axis):
        return frac.gather(1, axis[:, None])[:, 0]

    return a, e1, e2, sel(a), sel(e1), sel(e2)


def _level_face_rows(x01, res, size, is_hashed, u):
    """One level's face: the sampled axis's bit drawn (set when u < fa) →
    the 4 within-level corner indices [N, 4] of that cell face, in the
    order (b1, b2) = (0, 0), (0, 1), (1, 0), (1, 1) over the exact axes,
    and their f32 bilinear weights [N, 4]."""
    a, e1, e2, fa, f1, f2 = _level_face_axes(x01, res)
    base = (u < fa).to(torch.int64) << a
    idxs, ws = [], []
    for b1 in (0, 1):
        for b2 in (0, 1):
            corner = base + (b1 << e1) + (b2 << e2)
            idxs.append(_level_corner_index(x01, res, size, is_hashed,
                                            corner))
            ws.append((f1 if b1 else 1.0 - f1) * (f2 if b2 else 1.0 - f2))
    return torch.stack(idxs, 1), torch.stack(ws, 1)


def sampled_face_rows(x01: torch.Tensor, spec: HashGridSpec):
    """[N, 3] → (global indices [N, L, 4] int64 of the face each (point,
    level) draws, its bilinear weights [N, L, 4] f32), bit-equal to the JAX
    package's: the same salt-0 uniform as the single-corner draw."""
    u = _corner_uniform(x01, spec.n_levels)
    idx_all, w_all = [], []
    for lvl in range(spec.n_levels):
        idx, w = _level_face_rows(x01, spec.resolutions[lvl],
                                  spec.sizes[lvl], spec.hashed[lvl],
                                  u[:, lvl])
        idx_all.append(idx + spec.offsets[lvl])
        w_all.append(w)
    return torch.stack(idx_all, 1), torch.stack(w_all, 1)


def face_corner_indices(x01: torch.Tensor,
                        spec: HashGridSpec) -> torch.Tensor:
    """The face backward's one corner per (point, level) → its global table
    index, [N, L] int64: the sampled axis's bit from the forward's own
    salt-0 draw (so only rows the forward read), the exact axes' bits set
    when the E1 / E2 salts' uniforms fall below their fracs."""
    us = [_corner_uniform(x01, spec.n_levels, salt)
          for salt in (0, _FACE_SALT_E1, _FACE_SALT_E2)]
    idx_all = []
    for lvl in range(spec.n_levels):
        res = spec.resolutions[lvl]
        a, e1, e2, fa, f1, f2 = _level_face_axes(x01, res)
        corner = sum((u[:, lvl] < f).to(torch.int64) << axis
                     for u, f, axis in zip(us, (fa, f1, f2), (a, e1, e2)))
        idx_all.append(_level_corner_index(x01, res, spec.sizes[lvl],
                                           spec.hashed[lvl], corner)
                       + spec.offsets[lvl])
    return torch.stack(idx_all, dim=1)


def _blend(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [..., k, F] f32 (bf16 or fp8 values) times their f32 weights
    [..., k] rounded to bf16 (each product exact in f32), summed in f32 over
    k in order and rounded to bf16 once → [..., F] bf16."""
    prod = rows * w.to(torch.bfloat16).float()[..., None]
    acc = prod[..., 0, :]
    for c in range(1, prod.shape[-2]):
        acc = acc + prod[..., c, :]
    return acc.to(torch.bfloat16)


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
        feats.append(_blend(table_bf16[idx + spec.offsets[lvl]].float(), w))
    return torch.cat(feats, dim=1).reshape(n, spec.out_dim)


def hash_encode_face_plain(table_bf16: torch.Tensor, x01: torch.Tensor,
                           spec: HashGridSpec) -> torch.Tensor:
    """Plain version of the hash_encode_face_fwd kernel: per (point, level)
    the 4 rows of the face sampled_face_rows draws times their bilinear
    weights rounded to bf16 → [N, L·F] bf16. What XLA makes of the JAX
    package's `jnp.sum(feats * w.astype(bf16), axis=2)` under jit, as it
    runs in the trainer's step, established on the CPU against
    hash_encode_face_sampled: each product of two bf16 values exact in f32,
    the 4 products summed in f32 in the face's corner order, one rounding to
    bf16 (bit-equal on 6.4M elements of a table spanning 2^-12..1, where
    the pairwise order ((p0 + p1) + (p2 + p3)) differs on 13 of them).
    Outside jit, op by op, JAX rounds each product to bf16 first."""
    n = x01.shape[0]
    idx, w = sampled_face_rows(x01, spec)
    rows = table_bf16[idx.reshape(-1)].float().reshape(
        n, spec.n_levels, 4, spec.n_features)
    return _blend(rows, w).reshape(n, spec.out_dim)


_META = {}
# the feature widths the kernels are instantiated for (the shipped 8 × 4
# model and the default width), and the most levels they take
_KERNEL_FEATURES = (2, 4)
_KERNEL_MAX_LEVELS = 32


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
    if spec.n_levels > _KERNEL_MAX_LEVELS:
        raise ValueError(f"{name} takes at most {_KERNEL_MAX_LEVELS} levels, "
                         f"got {spec.n_levels}")
    kernels.check(x01, "x01", torch.float32, (x01.shape[0], 3))


def _launch_encode(name: str, table_bf16: torch.Tensor, x01: torch.Tensor,
                   spec: HashGridSpec) -> torch.Tensor:
    """Launch forward encode kernel `name` (table_bf16 [T, F] bf16, x01
    [N, 3] f32 on the card) → [N, L·F] bf16."""
    _check_kernel_args(name, x01, spec)
    n = x01.shape[0]
    kernels.check(table_bf16, "table_bf16", torch.bfloat16,
                  (spec.table_size, spec.n_features), x01.device)
    out = torch.empty((n, spec.out_dim), dtype=torch.bfloat16,
                      device=x01.device)
    if n:
        kernels.launch(name, table_bf16, x01, _level_meta(spec, x01.device),
                       out, n, spec.n_levels, spec.n_features)
    return out


def hash_encode(table_bf16: torch.Tensor, x01: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """table_bf16 [table_size, F] bf16, x01 [N, 3] f32 in [0, 1] →
    [N, L·F] bf16 features. CUDA tensors launch hash_encode_fwd; CPU tensors
    take hash_encode_plain."""
    if not x01.is_cuda:
        return hash_encode_plain(table_bf16, x01, spec)
    return _launch_encode("hash_encode_fwd", table_bf16, x01, spec)


def hash_encode_sampled_plain(table_bf16: torch.Tensor, x01: torch.Tensor,
                              spec: HashGridSpec) -> torch.Tensor:
    """Plain version of the hash_encode_sampled kernel: per (point, level)
    the bf16 row of the one corner sampled_corner_indices draws →
    [N, L·F] bf16."""
    idx = sampled_corner_indices(x01, spec)                    # [N, L]
    return table_bf16[idx.reshape(-1)].reshape(x01.shape[0], spec.out_dim)


def hash_encode_sampled(table_bf16: torch.Tensor, x01: torch.Tensor,
                        spec: HashGridSpec) -> torch.Tensor:
    """Single-corner forward of the occupancy probe and of the
    stochastic_fwd=True training encode: table_bf16 [T, F] bf16, x01 [N, 3]
    f32 → [N, L·F] bf16. CUDA tensors launch hash_encode_sampled; CPU
    tensors take the plain version."""
    if not x01.is_cuda:
        return hash_encode_sampled_plain(table_bf16, x01, spec)
    return _launch_encode("hash_encode_sampled", table_bf16, x01, spec)


def hash_encode_face(table_bf16: torch.Tensor, x01: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    """Face-sampled forward of the stochastic_fwd="face" training encode:
    table_bf16 [T, F] bf16, x01 [N, 3] f32 → [N, L·F] bf16. CUDA tensors
    launch hash_encode_face_fwd; CPU tensors take hash_encode_face_plain."""
    if not x01.is_cuda:
        return hash_encode_face_plain(table_bf16, x01, spec)
    return _launch_encode("hash_encode_face_fwd", table_bf16, x01, spec)


# hash_encode_bwd's modes, as the kernel numbers them
_BWD_MODES = {False: 0, True: 1, "face": 2}
# the kernel's sort indexes its contributions with 31 bits
_BWD_MAX_CONTRIBUTIONS = 2 ** 31


def _bwd_mode(stochastic) -> int:
    if stochastic not in _BWD_MODES:
        raise ValueError(f"stochastic: expected False, True or 'face', got "
                         f"{stochastic!r}")
    return _BWD_MODES[stochastic]


def hash_encode_bwd_plain(x01: torch.Tensor, g: torch.Tensor,
                          spec: HashGridSpec,
                          stochastic: bool | str) -> torch.Tensor:
    """Plain version of the hash_encode_bwd kernel: the gradient of the f32
    table [T, F] from the encode's cotangent g [N, L·F] (bf16, accumulated
    in f32). stochastic True: each (point, level) cotangent lands whole on
    the one corner sampled_corner_indices draws (`_hesg_bwd`, `_hesf_bwd`);
    "face": whole on the one corner face_corner_indices draws within the
    forward's face (`_hesface_bwd`); False: on all 8 corners times their f32
    trilinear weights (`_hef_bwd`)."""
    mode = _bwd_mode(stochastic)
    n, f = x01.shape[0], spec.n_features
    g = g.float().reshape(n, spec.n_levels, f)
    grad = torch.zeros((spec.table_size, f), dtype=torch.float32,
                       device=x01.device)
    if mode:
        draw = face_corner_indices if mode == 2 else sampled_corner_indices
        return grad.index_add_(0, draw(x01, spec).reshape(-1),
                               g.reshape(-1, f))
    for lvl in range(spec.n_levels):
        idx, w = _level_indices(x01, spec.resolutions[lvl], spec.sizes[lvl],
                                spec.hashed[lvl])
        contrib = w[..., None] * g[:, lvl, None, :]               # [N, 8, F]
        grad.index_add_(0, (idx + spec.offsets[lvl]).reshape(-1),
                        contrib.reshape(-1, f))
    return grad


_BWD_PLANS = {}


def _bwd_plan(spec: HashGridSpec, device):
    """The hash_encode_bwd kernel's buckets for `spec`, as its library's
    hash_encode_bwd_plan makes them: (int32 [3, L] on the device, the
    number of buckets, the digit passes). Made once per (spec, device)."""
    key = (spec, str(device))
    if key not in _BWD_PLANS:
        fn = kernels.entry("hash_encode_bwd", "hash_encode_bwd_plan",
                           [ctypes.c_void_p] * 2 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2)
        L = spec.n_levels
        sizes = (ctypes.c_int * L)(*spec.sizes)
        hashed = (ctypes.c_int * L)(*map(int, spec.hashed))
        plan, passes = (ctypes.c_int * (3 * L))(), ctypes.c_int()
        n_slots = fn(sizes, hashed, L, plan, ctypes.byref(passes))
        _BWD_PLANS[key] = (torch.tensor(list(plan), dtype=torch.int32,
                                        device=device).reshape(3, L),
                           n_slots, passes.value)
    return _BWD_PLANS[key]


def hash_encode_bwd(x01: torch.Tensor, g: torch.Tensor, spec: HashGridSpec,
                    stochastic: bool | str) -> torch.Tensor:
    """x01 [N, 3] f32, g [N, L·F] bf16 → f32 table gradient [T, F], as in
    hash_encode_bwd_plain (stochastic False, True or "face"). CUDA tensors
    launch hash_encode_bwd, which sorts the contributions by row and adds
    each row's in the plain version's order (the same bits every run, and
    the plain version's on the CPU); CPU tensors take the plain version.
    The kernel writes every row; its workspace is part of the call."""
    if not x01.is_cuda:
        return hash_encode_bwd_plain(x01, g, spec, stochastic)
    mode = _bwd_mode(stochastic)
    _check_kernel_args("hash_encode_bwd", x01, spec)
    n = x01.shape[0]
    kernels.check(g, "g", torch.bfloat16, (n, spec.out_dim), x01.device)
    if n * spec.n_levels * (8 if mode == 0 else 1) >= _BWD_MAX_CONTRIBUTIONS:
        raise ValueError(f"hash_encode_bwd takes fewer than 2^31 (point, "
                         f"level, corner) contributions, got {n} points × "
                         f"{spec.n_levels} levels in mode {mode}")
    if not n:
        return torch.zeros((spec.table_size, spec.n_features),
                           dtype=torch.float32, device=x01.device)
    # every row is written by the kernel
    grad = torch.empty((spec.table_size, spec.n_features),
                       dtype=torch.float32, device=x01.device)
    plan, n_slots, passes = _bwd_plan(spec, x01.device)
    n_bytes = kernels.entry(
        "hash_encode_bwd", "hash_encode_bwd_workspace", [ctypes.c_int] * 5,
        ctypes.c_longlong)(n, spec.n_levels, spec.n_features, mode, n_slots)
    work = torch.empty(n_bytes, dtype=torch.uint8, device=x01.device)
    kernels.launch("hash_encode_bwd", x01, g, _level_meta(spec, x01.device),
                   plan, grad, work, n, spec.n_levels, spec.n_features, mode,
                   passes, n_slots, n_bytes)
    return grad


class _HashEncode(torch.autograd.Function):
    """A table encode `encode(table_bf16, x01, spec)` on the bf16 copy whose
    backward is hash_encode_bwd(stochastic=bwd) into the gradient of the f32
    table, the autograd input: the exact encode (hash_encode, with the
    stochastic or the exact backward), the single-corner forward
    (hash_encode_sampled, its backward on the same drawn corner:
    `hash_encode_stochastic_fwd`) or the face forward (hash_encode_face,
    its backward on one corner of the same face:
    `hash_encode_stochastic_face`). No gradient reaches x01, as in the JAX
    package."""

    @staticmethod
    def forward(ctx, table, table_bf16, x01, spec, encode, bwd):
        ctx.save_for_backward(x01)
        ctx.spec, ctx.bwd = spec, bwd
        return encode(table_bf16, x01, spec)

    @staticmethod
    def backward(ctx, g):
        (x01,) = ctx.saved_tensors
        grad = hash_encode_bwd(x01, g.to(torch.bfloat16).contiguous(),
                               ctx.spec, ctx.bwd)
        return grad, None, None, None, None, None


def _packed_encode(packed, mode: str):
    """encode(table_bf16, x01, spec) through `packed` in `mode`, for
    _HashEncode (packed_table.hash_encode_packed is looked up at each call,
    so that kernels.plain_versions() swaps it)."""
    from . import packed_table
    return lambda tb, x01, spec: packed_table.hash_encode_packed(
        tb, packed, x01, spec, mode)


def hash_encode_packed_train(table, table_bf16, packed, x01, spec,
                             stochastic: bool) -> torch.Tensor:
    """The JAX package's hash_encode_packed_train: the forward through the
    packed table's exact mode (bit-equal to hash_encode with bf16 rows), the
    table gradient hash_encode_bwd's (stochastic True: the sampled corner,
    `_hesg_bwd`; False: all 8, `_hef_bwd`) into the f32 table. The packed
    table gets no gradient: it is a function of the table, built without
    one."""
    return _HashEncode.apply(table, table_bf16, x01, spec,
                             _packed_encode(packed, "exact"), stochastic)


def hash_encode_hybrid_train(table, table_bf16, packed, x01,
                             spec) -> torch.Tensor:
    """`stochastic_fwd="fine"` with a packed table (the JAX package's
    hash_encode_hybrid_train): the packed levels exact, the others one
    sampled corner (the packed table's probe mode); the backward the
    single-corner scatter on every level (`_hesg_bwd`, mode 1)."""
    return _HashEncode.apply(table, table_bf16, x01, spec,
                             _packed_encode(packed, "probe"), True)


def hash_encode_hybrid_face_train(table, table_bf16, packed, x01,
                                  spec) -> torch.Tensor:
    """`stochastic_fwd="face"` with a packed table (the JAX package's
    hash_encode_hybrid_face_train): the packed levels exact, the others the
    sampled face's 4 rows (the packed table's face mode); the backward one
    corner of the forward's face on every level (`_hesface_bwd`, mode 2),
    the face draw's corner distribution on the exact levels being their
    trilinear weights."""
    return _HashEncode.apply(table, table_bf16, x01, spec,
                             _packed_encode(packed, "face"), "face")


class HashGridEncoding(nn.Module):
    """Owns the f32 hash table [table_size, F] (parameter `table`, the JAX
    package's `encoder/table`) and its bf16 copy, cast once per version of
    the table and reused by every encode until the table changes.

    stochastic_grad: the table gradient takes one corner per (point, level)
    drawn by its trilinear weight (unbiased, 8× fewer scatter rows), else
    all 8 weighted corners.
    stochastic_fwd (training calls only, `train=True`): True samples the
    forward's corner too (hash_encode_sampled, 8× fewer reads); "face"
    samples the most certain axis's bit and blends that cell face's 4 rows
    (hash_encode_face); "fine" samples the corner of the levels a packed
    table leaves unpacked (hash_encode_hybrid_train) and, without a packed
    table, trains the exact encode, as the JAX package does. With a packed
    table (models/packed_table.py) "face" blends the face only there too
    (hash_encode_hybrid_face_train)."""

    def __init__(self, spec: HashGridSpec, device="cuda",
                 generator: torch.Generator | None = None,
                 init_range: float = 1e-4, stochastic_grad: bool = True,
                 stochastic_fwd: bool | str = False):
        super().__init__()
        device = resolve_device(device)
        if stochastic_fwd not in (False, True, "fine", "face"):
            raise ValueError(f"stochastic_fwd={stochastic_fwd!r}: expected "
                             f"False, True, 'fine' or 'face'")
        self.spec = spec
        self.stochastic_grad = stochastic_grad
        self.stochastic_fwd = stochastic_fwd
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

    def forward(self, x01: torch.Tensor, probe: bool = False,
                train: bool = False, packed=None) -> torch.Tensor:
        """x01 [N, 3] in [0, 1] → [N, L·F] bf16, dispatched as the JAX
        package's HashGridEncoding: train (a training step's density call)
        with stochastic_fwd "fine" and a packed table: the hybrid; "face":
        the face forward (with a packed table, its hybrid); a packed table
        otherwise (unless train with stochastic_fwd True): its probe mode
        when probe, else its exact mode with this encoder's backward; probe:
        the single-corner sampled encode of the occupancy refresh (no
        gradient); train with stochastic_fwd True: the single-corner
        forward with its backward; else the exact encode ("fine" without a
        packed table lands here too). Differentiable in the table when grad
        is enabled (the probe excepted)."""
        tb = self.table_bf16()
        sfwd, spec = self.stochastic_fwd, self.spec
        if train and sfwd == "fine" and packed is not None:
            return hash_encode_hybrid_train(self.table, tb, packed, x01,
                                            spec)
        if train and sfwd == "face":
            if packed is not None:
                return hash_encode_hybrid_face_train(self.table, tb, packed,
                                                     x01, spec)
            encode, bwd = hash_encode_face, "face"
        elif packed is not None and not (train and sfwd):
            if probe:
                return _packed_encode(packed, "probe")(tb, x01, spec)
            return hash_encode_packed_train(self.table, tb, packed, x01,
                                            spec, self.stochastic_grad)
        elif probe:
            return hash_encode_sampled(tb, x01, spec)
        elif train and sfwd is True:
            encode, bwd = hash_encode_sampled, True
        else:
            encode, bwd = hash_encode, self.stochastic_grad
        return _HashEncode.apply(self.table, tb, x01, spec, encode, bwd)
