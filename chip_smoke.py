#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ucsa_neural_rendering_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds, renders and trains
there.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --out DIR  # where chip_smoke.json and the profile
                                     # table go (default build/chip_smoke)

Phases (any failure exits nonzero; nothing is caught to keep exit code 0):
  1. CUDA present; the card's name and power limit from nvidia-smi.
  2. Build the eleven CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas reports.
  3. Hold each kernel against its plain PyTorch version on the card, at the
     shapes the render and training paths give it (both placement modes,
     det and per-ray random u; each MLP at the training step's, the test
     and predict renders' and the refresh chunk's numbers of points), and
     the row gather at the benchmark's shapes, with the tolerance stated
     beside each check; time them by device time (the profiler's), not
     between CUDA events, which around ~20 µs calls back to back time the
     host. occ_placement is timed at all five path shapes (test and
     predict stage 1 and refine, the step's), importance_resample at all
     three, hash_encode_fwd at all eight density calls (test and predict
     stage 1, both refine passes' coarse and new samples, the step's two;
     bit-equal to its plain version), mlp_fwd at all fourteen, mlp_bwd at
     the step's four with its kernel and its dW reduction apart, and
     hash_encode_bwd's call also in its parts (the kernel alone and the
     zeroed gradient alone); the first versions' times (before each
     kernel's redesign) are printed beside theirs.
  4. The render path: NeRFTrainer.render_image at full width — Semantic-NeRF
     8 levels × 4 features, 2^19 table, bound 4, 40 classes, seeded random
     weights (table U(-1, 1)) and a seeded 128³ occupancy grid — renders 3
     frames of 240×320 under the test config and 3 under the predict config
     derived from the shipped train budget. Launch counts are zeroed just
     before and read just after; every kernel of the path must have
     launched. The same frames rendered through the plain versions on the
     card must agree; they are timed again with only the MLP kernels plain.
  5. The training path: a fresh shipped-config model (tcnn table init
     U(-1e-4, 1e-4), lecun MLPs) fits the kernel path's phase-4 test
     renders (rgb, argmax labels, depth) with NeRFTrainer.train_step —
     4096 rays, 24 proposal-placed + 8 importance samples, stochastic table
     gradients, Adam — from an all-ones grid, with update_occupancy every 16
     steps: 32 steps on the kernel path (counts zeroed before, read after,
     the refreshes' apart; every kernel of the path must have launched, the
     MLP forward in the refresh too), then 32 from the same init and
     generator seed with only the MLP kernels plain, and 32 inside
     plain_versions() (no launch). The first step's losses and per-level
     table-gradient sums must agree, and the mean loss of the last 8
     kernel-path steps must be below the first's. Then 3 steps at the
     trainer's default RenderConfig() (256 + 256 samples a ray), on the
     kernel path in turns with the plain path, held to the same step-1
     limits. The profiled frame and step report each kernel's device
     time.
  6. The row-gather benchmark (python -m
     ucsa_neural_rendering_tpu_torch.bench.dma_gather), counts zeroed
     before and read after: ns per row at each row width.
  7. One JSON line of per-kernel numbers, then the last line
     {"ok": true, "device": {...}}.

Bounds (bound_ms) are the larger of bytes / 3.35 TB/s and operations / peak
(67 TFLOP/s f32 outside the tensor cores; 989 TFLOP/s for the MLPs' bf16
products on the tensor cores), from the published H100 SXM figures, with
the bytes and operations each kernel's work needs on this run's inputs
(formulas beside each kernel below). `launches` is the sum over the render
and training paths' runs (the gather's: its benchmark's); chip_smoke.json
has them apart. The MLP kernels' line sums the four calls of one training
step; chip_smoke.json has every shape.
"""

import argparse
import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

RENDER_KERNELS = ("hash_encode_fwd", "occ_placement", "importance_resample",
                  "composite_fwd", "mlp_fwd")
MLP_KERNELS = ("mlp_fwd", "mlp_bwd")
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, on the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def bound_by(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    return "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / ops_per_s \
        else "operations"


# the first versions' device times, the kernels before their redesign
# (importance_resample and occ_placement: one thread per ray;
# hash_encode_bwd: one thread per (point, level) with F scalar atomics;
# mlp_fwd: 4-warp blocks, 6 an SM, each loading the weights, scalar row
# loads; mlp_bwd: the same blocks with the dW partials in shared memory and
# a one-thread-a-column reduction; hash_encode_fwd: one thread per (point,
# level), a point's levels on neighbouring threads), measured by this
# script's phase 3 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6),
# printed beside this run's; None where that shape was not timed
FIRST_VERSION_MS = {
    ("importance_resample", "test refine"): 0.2438,
    ("importance_resample", "predict refine"): None,
    ("importance_resample", "train step"): None,
    ("hash_encode_bwd", "call"): 0.1103,
    ("occ_placement", "test stage 1"): 0.1063,
    ("occ_placement", "test refine"): 0.1351,
    ("occ_placement", "predict stage 1"): 0.0906,
    ("occ_placement", "predict refine"): 0.1020,
    ("occ_placement", "train step"): 0.3104,
    # mlp_fwd, keyed "<where> <net> <points>"
    ("mlp_fwd", "step sigma 98304"): 0.0250,
    ("mlp_fwd", "step sigma 32768"): 0.0112,
    ("mlp_fwd", "step color 131072"): 0.0416,
    ("mlp_fwd", "step semantics 131072"): 0.0350,
    ("mlp_fwd", "render sigma 65536"): 0.0185,
    ("mlp_fwd", "render color 65536"): 0.0270,
    ("mlp_fwd", "render semantics 65536"): 0.0216,
    ("mlp_fwd", "render sigma 32768"): 0.0108,
    ("mlp_fwd", "render color 32768"): 0.0157,
    ("mlp_fwd", "render semantics 32768"): 0.0124,
    ("mlp_fwd", "render sigma 8192"): 0.0062,
    ("mlp_fwd", "render color 16384"): 0.0105,
    ("mlp_fwd", "render semantics 16384"): 0.0090,
    ("mlp_fwd", "refresh sigma 262144"): 0.0568,
    # mlp_bwd, keyed as mlp_fwd
    ("mlp_bwd", "step sigma 98304"): 0.0686,
    ("mlp_bwd", "step sigma 32768"): 0.0318,
    ("mlp_bwd", "step color 131072"): 0.1457,
    ("mlp_bwd", "step semantics 131072"): 0.0950,
    # hash_encode_fwd, keyed by the density call of the path
    ("hash_encode_fwd", "test stage 1"): 0.0326,
    ("hash_encode_fwd", "test refine coarse"): 0.0186,
    ("hash_encode_fwd", "test refine new"): 0.0176,
    ("hash_encode_fwd", "predict stage 1"): 0.0182,
    ("hash_encode_fwd", "predict refine coarse"): 0.0056,
    ("hash_encode_fwd", "predict refine new"): 0.0054,
    ("hash_encode_fwd", "train step coarse"): 0.0451,
    ("hash_encode_fwd", "train step new"): 0.0185,
}


def first_version(*key):
    ms = FIRST_VERSION_MS.get(key)
    return "not measured" if ms is None else f"{ms:.4f} ms"


def placement_work(n, n_cand, s, cells, random_u):
    """(bytes, operations) of occ_placement on n rays of s samples: rays in,
    the per-ray u in where given, z out, each distinct grid cell the
    candidates touch read once; ~40 ops per candidate weight, each computed
    once, ~20 per sample."""
    return (n * 24 + n * s * 4 * (2 if random_u else 1) + cells * 4,
            n * (n_cand * 40 + s * 20))


def check_placement(label, o, d, grid, bound, s, cfg, proposal, u=None,
                    timed=True):
    """occ_placement against its plain version on one path shape: sorted,
    finite, max |Δz| 2e-3 and mean 1e-5 (the inverse CDF: the kernel's warp
    scans sum in another order, and a cdf ulp moves z by ulp·width/pdf; z
    spans up to ~14 scene units). The kernel sorts each ray's z, so with
    random u its row is the plain one sorted, as the plain version returns
    it. Returns the kernel's z and the shape's row (times and bound when
    timed)."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops.aabb import near_far_from_aabb
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import cell_index
    args = (o, d, grid, bound, s, cfg.occ_candidates, cfg.min_near, proposal,
            cfg.occ_floor, cfg.occ_density_threshold, cfg.density_scale, u)
    zk, zp = pl.occ_placement(*args), pl.occ_placement_plain(*args)
    torch.cuda.synchronize()
    err, mean = (zk - zp).abs().max().item(), (zk - zp).abs().mean().item()
    n = o.shape[0]
    what = (f"occ_placement {label} [{n},{s}] "
            f"{'proposal' if proposal else 'binary'}"
            f"{', random u' if u is not None else ''}")
    assert torch.isfinite(zk).all() and err <= 2e-3 and mean <= 1e-5, \
        (what, err, mean)
    assert (zk[:, 1:] >= zk[:, :-1]).all(), what
    row = dict(where=label, rays=n, samples=s, proposal=proposal,
               random_u=u is not None, max_abs_err=err, mean_abs_err=mean)
    if not timed:
        log(f"  {what}: max {err:.3e} mean {mean:.3e}")
        return zk, row
    cand = pl.linspace(0.0, 1.0, cfg.occ_candidates, o.device)
    nears, fars = near_far_from_aabb(o, d, pl._aabb(bound, o.device),
                                     cfg.min_near)
    cz = nears[:, None] + (fars - nears)[:, None] * cand
    cells = torch.unique(cell_index(o[:, None] + d[:, None] * cz[..., None],
                                    bound, grid.shape[0])).numel()
    n_bytes, n_ops = placement_work(n, cfg.occ_candidates, s, cells,
                                    u is not None)
    row.update(grid_cells=cells,
               ms=device_ms(lambda: pl.occ_placement(*args)),
               plain_ms=device_ms(lambda: pl.occ_placement_plain(*args),
                                  iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    log(f"  {what}: max {err:.3e} mean {mean:.3e}; kernel {row['ms']:.4f} ms"
        f" (first version: {first_version('occ_placement', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {cells} grid cells)")
    return zk, row


def resample_work(n, s1, s2):
    """(bytes, operations) of importance_resample on n rays: z, sigma in;
    new z, merged z and the order out, the order at 4 B as JAX's int32
    argsort (the int64 the port writes, for take_along_dim, is its design,
    not the function's); each coarse weight once (~10 ops + exp), ~20 per
    new sample, ~4 per merged sample."""
    m = s1 + s2
    return n * (s1 * 8 + s2 * 4 + m * 8), n * (s1 * 12 + s2 * 20 + m * 4)


def check_resample(label, z, sig, s2, scale, u=None):
    """importance_resample against its plain version on one path shape,
    timed: new z (as a set) and merged z within 2e-3, mean 1e-5 (the scans
    sum in another order: a cdf ulp moves z by ulp·width/pdf, and z spans
    up to ~14 scene units); the order the stable argsort of the kernel's
    own [z, new_z] and, for det u, the plain one on >= 0.98 of rays
    (near-ties may differ). Returns the kernel's outputs and the shape's
    numbers."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    nk, zk, ok = pl.importance_resample(z, sig, s2, scale, u)
    npl, zp, op = pl.importance_resample_plain(z, sig, s2, scale, u)
    torch.cuda.synchronize()
    dz = torch.cat([torch.sort(nk, -1).values - torch.sort(npl, -1).values,
                    zk - zp], -1).abs()
    err, mean = dz.max().item(), dz.mean().item()
    z_all = torch.cat([z, nk], -1)
    assert torch.isfinite(zk).all() and err <= 2e-3 and mean <= 1e-5, \
        (label, err, mean)
    assert torch.equal(ok, torch.sort(z_all, dim=-1, stable=True).indices)
    assert torch.equal(torch.take_along_dim(z_all, ok, -1), zk)
    same = None
    if u is None:
        same = (ok == op).all(dim=-1).float().mean().item()
        assert same >= 0.98, (label, same)
    n, s1 = z.shape
    n_bytes, n_ops = resample_work(n, s1, s2)
    row = dict(where=label, rays=n, s1=s1, s2=s2, max_abs_err=err,
               mean_abs_err=mean, order_equal=same,
               ms=device_ms(lambda: pl.importance_resample(z, sig, s2, scale,
                                                           u)),
               plain_ms=device_ms(lambda: pl.importance_resample_plain(
                   z, sig, s2, scale, u), iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops))
    order = "" if same is None else f", order equal on {same:.4f} of rays"
    log(f"  importance_resample {label} [{n},{s1}]+{s2}: max {err:.3e} mean "
        f"{mean:.3e}{order}; kernel {row['ms']:.4f} ms (first version: "
        f"{first_version('importance_resample', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms")
    return nk, zk, ok, row


def check_encode(label, model, x):
    """hash_encode_fwd on one density call's points x [N, 3] of a path:
    bit-equal to its plain version (both sum the same exact f32 products in
    the same order), timed. Returns the shape's row."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    bound = model.bound
    x01 = ((x + bound) / (2.0 * bound)).contiguous()
    tb = model.encoder.table_bf16()
    spec = model.encoder.spec
    hk = he.hash_encode(tb, x01, spec)
    assert torch.equal(hk, he.hash_encode_plain(tb, x01, spec)), label
    npts, L, F = x01.shape[0], spec.n_levels, spec.n_features
    # distinct table rows, and the L2 sectors the gathers touch: each warp
    # load (32 consecutive points at one level, one corner) counted as its
    # distinct 32-byte sectors
    rows = sectors = 0
    warp_corner = (torch.arange(npts, device=x.device)[:, None] // 32 * 8
                   + torch.arange(8, device=x.device)[None]) << 32
    for lv in range(L):
        idx = he._level_indices(x01, spec.resolutions[lv], spec.sizes[lv],
                                spec.hashed[lv])[0] + spec.offsets[lv]
        rows += torch.unique(idx).numel()
        sectors += torch.unique(warp_corner + idx * F * 2 // 32).numel()
    # points in, features out, each distinct table row read once; per
    # (point, level): 3 frac + 8 corners × (2 weight muls + F multiply-adds
    # + ~6 integer hash ops)
    n_bytes = npts * 12 + npts * L * F * 2 + rows * F * 2
    n_ops = npts * L * (3 + 8 * (2 + 2 * F + 6))
    row = dict(where=label, points=npts, distinct_rows=rows,
               sector_bytes=32 * sectors, max_abs_err=0.0,
               ms=device_ms(lambda: he.hash_encode(tb, x01, spec)),
               plain_ms=device_ms(lambda: he.hash_encode_plain(tb, x01, spec),
                                  iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    log(f"  hash_encode_fwd {label} [{npts},3] → [{npts},{L * F}]: bit-equal;"
        f" kernel {row['ms']:.4f} ms (first version: "
        f"{first_version('hash_encode_fwd', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {rows} distinct rows; the warps' loads touch "
        f"{32 * sectors / 1e6:.2f} MB of 32-byte sectors, "
        f"{32 * sectors / row['ms'] / 1e9:.2f} TB/s)")
    return row


# --------------------------------------------------------------------- scene
def look_at(pos, target=(0.0, 0.0, 0.0)):
    """c2w [4,4] whose camera z axis looks from pos at target (x right,
    y down in the image, as get_rays' pixel directions)."""
    import numpy as np
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, pos
    return pose


POSES = [(0.0, 0.3, -3.0), (2.2, -0.4, -2.0), (-2.0, 0.6, 2.5)]
INTRINSICS = (277.0, 277.0, 160.0, 120.0)  # fx, fy, cx, cy at 240×320


def make_scene(device, seed=0, n_levels=8, n_features=4, log2=19, bound=4.0,
               classes=40, grid_res=128, sigma_scale=24.0):
    """Seeded full-width model and occupancy grid. The table is U(-1, 1),
    level l scaled by 2^-l so that, as in a fitted scene, the fine levels
    carry detail and not the bulk of the field (a field that is white noise
    at the finest cell would turn f32 rounding of the sample positions into
    different renders). The density output's weights are made non-positive
    and 24× wider, so that most of the volume is near-empty as in a fitted
    scene and, in both render configs, more rays stay unsaturated after
    stage 1 than early stop may refine (its top-K cut binds)."""
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    gen = torch.Generator().manual_seed(seed)
    model = SemanticNeRF(bound=bound, num_semantic_classes=classes,
                         n_levels=n_levels, n_features=n_features,
                         log2_hashmap_size=log2, device=device,
                         generator=gen, table_init_range=1.0)
    spec = model.encoder.spec
    with torch.no_grad():
        for lvl in range(spec.n_levels):
            a = spec.offsets[lvl]
            model.encoder.table[a:a + spec.sizes[lvl]] *= 0.5 ** lvl
        w = model.sigma_net.layers[-1].weight
        w[0] = -sigma_scale * w[0].abs()
    r = grid_res
    occupied = torch.rand((r, r, r), generator=gen) > 0.5
    grid = torch.where(occupied, 20.0 * torch.rand((r, r, r), generator=gen),
                       torch.full((r, r, r), 1e-3)).to(device)
    return model, grid


def render_configs():
    """The JointTrainer's derived full-frame configs for the shipped train
    budget (JAX package train/joint_trainer.py:96-136): proposal training
    at 24+8 → test 32+32 with early stop (stage 1: 16, top 1/4 refined,
    binary placement) → predict es8→16+16, top 1/8."""
    from ucsa_neural_rendering_tpu_torch.config import SHIPPED_TRAIN_BUDGET
    from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
    total = sum(SHIPPED_TRAIN_BUDGET)
    test = RenderConfig(num_steps=total, upsample_steps=total,
                        early_stop=True,
                        stage1_steps=max(1, min(16, total // 2)),
                        refine_fraction=0.25, proposal_placement=False,
                        max_ray_batch=4096)
    predict = replace(test, stage1_steps=max(1, test.stage1_steps // 2),
                      num_steps=max(1, test.num_steps // 2),
                      upsample_steps=max(1, test.upsample_steps // 2),
                      refine_fraction=0.125)
    return {"test": test, "predict": predict}


# ------------------------------------------------------------- kernel checks
def recorder(rec):
    """record(name, err, fn_k, fn_p, n_bytes, n_ops, replaces, source,
    extra="", fn_lib=None): time kernel, plain version and, where one
    PyTorch call computes the same function, that call; put the numbers in
    rec[name]."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms

    def record(name, err, fn_k, fn_p, n_bytes, n_ops, replaces, source,
               extra="", fn_lib=None):
        ms = device_ms(fn_k)
        plain_ms = device_ms(fn_p, iters=5, warmup=1)
        lib_ms = device_ms(fn_lib) if fn_lib else None
        rec[name] = dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=float(err), ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms(n_bytes, n_ops),
                         bound_by=bound_by(n_bytes, n_ops), library_ms=lib_ms)
        lib = f"library {lib_ms:.4f} ms  " if fn_lib else ""
        log(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  {lib}bound {rec[name]['bound_ms']:.4f} ms "
            f"({rec[name]['bound_by']}) {extra}")
    return record


def check_kernels(model, grid, cfgs, device):
    """Phase 3: each kernel against its plain version at the render path's
    shapes; returns {name: record} with error, times and bound."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    from ucsa_neural_rendering_tpu_torch.ops.renderer import _points

    test = cfgs["test"]
    chunk = test.max_ray_batch
    k_refine = int(round(chunk * test.refine_fraction))
    rays = get_rays(look_at(POSES[0]), INTRINSICS, 240, 320, device=device)
    o = rays["rays_o"][:chunk].contiguous()
    d = rays["rays_d"][:chunk].contiguous()
    dn = rays["direction_norms"][:chunk].contiguous()
    bound = model.bound
    rec = {}

    record = recorder(rec)

    # occ_placement at the render paths' shapes: stage 1 and the refine
    # pass's coarse placement of the test config ([4096, 16], [1024, 32])
    # and of the predict config ([4096, 8], [512, 16]); timed in the binary
    # mode with det u, as both configs place, and held in the proposal mode
    # too. The record's numbers are the test config's stage 1.
    predict = cfgs["predict"]
    occ_rows, enc_rows = [], []
    for label, cfg, frac, s in (
            ("test stage 1", test, 1.0, test.stage1_steps),
            ("test refine", test, test.refine_fraction, test.num_steps),
            ("predict stage 1", predict, 1.0, predict.stage1_steps),
            ("predict refine", predict, predict.refine_fraction,
             predict.num_steps)):
        k = max(1, int(round(chunk * frac)))
        check_placement(label, o[:k], d[:k], grid, bound, s, cfg,
                        not cfg.proposal_placement, timed=False)
        zk, row = check_placement(label, o[:k], d[:k], grid, bound, s, cfg,
                                  cfg.proposal_placement)
        occ_rows.append(row)
        if label.endswith("stage 1"):
            enc_rows.append(check_encode(label, model,
                                         _points(o, d, zk, bound)))
    head = occ_rows[0]
    rec["occ_placement"] = dict(
        name="occ_placement", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/occ_placement.cu",
        replaces="ucsa_neural_rendering_tpu/ops/renderer.py:262",
        max_abs_err=max(r["max_abs_err"] for r in occ_rows), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, shapes=occ_rows)

    # importance_resample on the refine passes' coarse samples: the test
    # config's [1024, 32 + 32] (the record's numbers) and the predict
    # config's [512, 16 + 16]
    def refine_inputs(cfg):
        k = int(round(chunk * cfg.refine_fraction))
        z = pl.occ_placement(o[:k], d[:k], grid, bound, cfg.num_steps,
                             cfg.occ_candidates, cfg.min_near, False,
                             cfg.occ_floor, cfg.occ_density_threshold,
                             cfg.density_scale)
        sigma = model.density(_points(o[:k], d[:k], z, bound))[0]
        return z, sigma.reshape(k, cfg.num_steps).contiguous()

    # and hash_encode_fwd on the refine passes' two density calls: the
    # coarse samples and the new ones
    def refine(label, cfg):
        k = int(round(chunk * cfg.refine_fraction))
        z_c, sig = refine_inputs(cfg)
        out = check_resample(label, z_c, sig, cfg.upsample_steps,
                             cfg.density_scale)
        for what, z in (("coarse", z_c), ("new", out[0])):
            enc_rows.append(check_encode(
                f"{label} {what}", model, _points(o[:k], d[:k], z, bound)))
        return z_c, sig, out

    s2 = test.upsample_steps
    m = s2 + test.num_steps
    z_c, sig, (nk, zk_all, ok, test_row) = refine("test refine", test)
    predict_row = refine("predict refine", predict)[2][3]
    head = enc_rows[0]
    rec["hash_encode_fwd"] = dict(
        name="hash_encode_fwd", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/hash_encode_fwd.cu",
        replaces="ucsa_neural_rendering_tpu/models/hash_encoding.py:202",
        max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=None, shapes=enc_rows)
    n_bytes, n_ops = resample_work(k_refine, test.num_steps, s2)
    rec["importance_resample"] = dict(
        name="importance_resample", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/importance_resample.cu",
        replaces="ucsa_neural_rendering_tpu/ops/renderer.py:305",
        max_abs_err=max(test_row["max_abs_err"], predict_row["max_abs_err"]),
        ms=test_row["ms"], plain_ms=test_row["plain_ms"],
        bound_ms=test_row["bound_ms"], bound_by=bound_by(n_bytes, n_ops),
        library_ms=None, shapes=[test_row, predict_row])

    # composite_fwd on the refine pass's merged samples (1024 × 64, C = 40)
    sig_all = torch.take_along_dim(
        torch.cat([sig, model.density(_points(
            o[:k_refine], d[:k_refine], nk, bound))[0].reshape(k_refine, s2)],
            -1), ok, -1).contiguous()
    geo = model.density(_points(o[:k_refine], d[:k_refine], zk_all,
                                bound))[1]
    dirs = d[:k_refine, None, :].expand(k_refine, m, 3).reshape(-1, 3)
    rgb = model.color(dirs, geo).reshape(k_refine, m, 3).contiguous()
    sem = model.semantics(geo).reshape(k_refine, m, -1).contiguous()
    c = sem.shape[-1]
    dk = dn[:k_refine].contiguous()
    outk = cp.composite_fwd(zk_all, sig_all, rgb, sem, dk,
                            test.density_scale, test.weight_mask_threshold)
    outp = cp.composite_fwd_plain(zk_all, sig_all, rgb, sem, dk,
                                  test.density_scale,
                                  test.weight_mask_threshold)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(outk, outp)]
    # f32 sums over 64 samples in another order (and the w > 1e-4 mask at
    # equal weights): 1e-5 on rgb / semantics mass, 1e-4 on depth (≤ 14)
    assert errs[0] <= 1e-5 and errs[1] <= 1e-5 and errs[2] <= 1e-4, errs
    record("composite_fwd", max(errs),
           lambda: cp.composite_fwd(zk_all, sig_all, rgb, sem, dk,
                                    test.density_scale,
                                    test.weight_mask_threshold),
           lambda: cp.composite_fwd_plain(zk_all, sig_all, rgb, sem, dk,
                                          test.density_scale,
                                          test.weight_mask_threshold),
           # z, sigma, rgb, semantics, norms in; image, semantics, depth out
           k_refine * (m * (8 + 12 + 4 * c) + 4 + (3 + c + 1) * 4),
           # per sample: ~8 for the weight, 2 per output channel
           k_refine * m * (8 + 2 * (3 + c + 1)),
           "ucsa_neural_rendering_tpu/ops/compositing.py:16",
           "ucsa_neural_rendering_tpu_torch/csrc/composite_fwd.cu",
           f"([{k_refine},{m}], C={c})")
    kernels.reset_launches()  # the comparisons above are not the main path
    return rec


N_RAYS = 4096  # rays per training step (the shipped step, bench.py)
DEFAULT_CFG_STEPS = 3  # steps at the trainer's default RenderConfig()
# the shipped model (config/shipped.py, JAX train/joint_trainer.py:142-143)
TRAIN_MODEL = dict(bound=4.0, num_semantic_classes=40, n_levels=8,
                   n_features=4, log2_hashmap_size=19)


def train_config():
    """The shipped training render: 24 proposal-placed + 8 importance
    samples (config/shipped.py)."""
    from ucsa_neural_rendering_tpu_torch.config import (SHIPPED_PROPOSAL,
                                                        SHIPPED_TRAIN_BUDGET)
    from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
    coarse, fine = SHIPPED_TRAIN_BUDGET
    return RenderConfig(num_steps=coarse, upsample_steps=fine,
                        proposal_placement=SHIPPED_PROPOSAL)


@torch.no_grad()
def check_train_kernels(model, grid, device, rec):
    """Phase 3, training path: the two placement kernels with a training
    step's per-ray random u, and the four kernels of the backward and the
    refresh, against their plain versions at the training path's shapes."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays_sampled
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    from ucsa_neural_rendering_tpu_torch.ops import occupancy as oc
    from ucsa_neural_rendering_tpu_torch.ops.renderer import _points

    record = recorder(rec)
    cfg = train_config()
    gen = torch.Generator(device).manual_seed(7)
    o, d, dn, _ = get_rays_sampled(look_at(POSES[0]), INTRINSICS, 240, 320,
                                   N_RAYS, gen, device=device)
    s1, s2 = cfg.num_steps, cfg.upsample_steps
    u_c = torch.rand((N_RAYS, s1), generator=gen, device=device)
    u_f = torch.rand((N_RAYS, s2), generator=gen, device=device)
    bound, scale = model.bound, cfg.density_scale
    spec = model.encoder.spec
    L, F = spec.n_levels, spec.n_features

    # placement with per-ray u: coarse [4096, 24] (proposal), fine 24 + 8.
    # The kernels sort each ray's z; the inverse CDF is monotone, so the
    # coarse z (sorted) are the plain version's, the fine new z the same
    # set: compare sorted. Tolerances as for det u.
    zk, row = check_placement("train step", o, d, grid, bound, s1, cfg,
                              cfg.proposal_placement, u_c)
    occ = rec["occ_placement"]
    occ["shapes"].append(row)
    occ["max_abs_err"] = max(occ["max_abs_err"], row["max_abs_err"])
    sig = model.density(_points(o, d, zk, bound))[0].reshape(N_RAYS, s1)
    nk, zsk, _, row = check_resample("train step", zk, sig.contiguous(), s2,
                                     scale, u_f)
    res = rec["importance_resample"]
    res["shapes"].append(row)
    res["max_abs_err"] = max(res["max_abs_err"], row["max_abs_err"])
    for what, z in (("coarse", zk), ("new", nk)):
        rec["hash_encode_fwd"]["shapes"].append(check_encode(
            f"train step {what}", model, _points(o, d, z, bound)))

    # hash_encode_bwd on the step's 4096 × 32 points and one cotangent
    x01 = ((_points(o, d, zsk, bound) + bound) / (2.0 * bound)).contiguous()
    npts = x01.shape[0]
    g = torch.randn((npts, L * F), generator=gen, device=device
                    ).to(torch.bfloat16)
    errs = {}
    for stochastic in (True, False):
        ref = he.hash_encode_bwd_plain(x01, g, spec, stochastic)
        mass = he.hash_encode_bwd_plain(x01, g.abs(), spec, stochastic)
        out = he.hash_encode_bwd(x01, g, spec, stochastic)
        torch.cuda.synchronize()
        # the same f32 contributions summed in another order (reductions
        # against index_add_): within 1e-5 of the |contributions| on it
        assert ((out - ref).abs() <= 1e-5 * mass).all(), stochastic
        errs[stochastic] = (out - ref).abs().max().item()
    exact_ms = device_ms(lambda: he.hash_encode_bwd(x01, g, spec, False))
    idx = he.sampled_corner_indices(x01, spec).reshape(-1)
    g_rows = g.float().reshape(-1, F)
    acc = torch.zeros((spec.table_size, F), device=device)
    record("hash_encode_bwd", errs[True],
           lambda: he.hash_encode_bwd(x01, g, spec, True),
           lambda: he.hash_encode_bwd_plain(x01, g, spec, True),
           # points and cotangent in, the [T, F] f32 gradient out once
           npts * 12 + npts * L * F * 2 + spec.table_size * F * 4,
           # per (point, level): 3 frac, 8 × (3 weight ops + cdf add and
           # compare), ~12 hash ops, F adds
           npts * L * (3 + 8 * 5 + 12 + F),
           "ucsa_neural_rendering_tpu/models/hash_encoding.py:436",
           "ucsa_neural_rendering_tpu_torch/csrc/hash_encode_bwd.cu",
           f"(stochastic, [{npts},{L * F}] → [{spec.table_size},{F}]; exact "
           f"mode {exact_ms:.4f} ms, max_abs_err {errs[False]:.3e}; library"
           f" = index_add_ of the drawn rows)",
           fn_lib=lambda: acc.index_add_(0, idx, g_rows))
    bwd = rec["hash_encode_bwd"]
    bwd["exact_ms"] = exact_ms
    bwd["exact_max_abs_err"] = errs[False]
    # the call's two parts apart: the kernel alone, launched into a gradient
    # zeroed once (it only accumulates), and the torch.zeros of the gradient
    meta = he._level_meta(spec, device)
    bwd["kernel_only_ms"] = device_ms(lambda: kernels.launch(
        "hash_encode_bwd", x01, g, meta, acc, npts, L, F, 1))
    bwd["zeros_ms"] = device_ms(lambda: torch.zeros(
        (spec.table_size, F), device=device))
    log(f"  hash_encode_bwd call {bwd['ms']:.4f} ms (first version: "
        f"{first_version('hash_encode_bwd', 'call')}) = zeros "
        f"{bwd['zeros_ms']:.4f} ms + kernel alone "
        f"{bwd['kernel_only_ms']:.4f} ms; index_add_ "
        f"{bwd['library_ms']:.4f} ms")

    # composite_bwd on the step's merged [4096, 32] samples, C = 40
    t = s1 + s2
    sigma, geo = model.density(_points(o, d, zsk, bound))
    sigma = sigma.reshape(N_RAYS, t).contiguous()
    dirs = d[:, None, :].expand(N_RAYS, t, 3).reshape(-1, 3)
    rgb = model.color(dirs, geo).reshape(N_RAYS, t, 3).contiguous()
    sem = model.semantics(geo).reshape(N_RAYS, t, -1).contiguous()
    c = sem.shape[-1]
    cots = [torch.randn(shape, generator=gen, device=device)
            for shape in ((N_RAYS, 3), (N_RAYS, c), (N_RAYS,))]
    cargs = (zsk, sigma, rgb, sem, dn, *cots, scale,
             cfg.weight_mask_threshold)
    outk = cp.composite_bwd(*cargs)
    outp = cp.composite_bwd_plain(*cargs)
    torch.cuda.synchronize()
    # d sigma: suffix sums against autograd's division through cumprod:
    # rtol 1e-3 with an atol of 1e-4 of the ray's largest |d sigma| short of
    # its last sample (δ = 1e10 there); d rgb, d sem: the same weights times
    # the cotangent, 1e-5
    ray_scale = outp[0][:, :-1].abs().amax(-1, keepdim=True)
    assert all(torch.isfinite(a).all() for a in outk)
    assert ((outk[0] - outp[0]).abs() <= 1e-3 * outp[0].abs()
            + 1e-4 * ray_scale).all()
    errs = [(a - b).abs().max().item() for a, b in zip(outk, outp)]
    assert errs[1] <= 1e-5 and errs[2] <= 1e-5, errs
    record("composite_bwd", max(errs), lambda: cp.composite_bwd(*cargs),
           lambda: cp.composite_bwd_plain(*cargs),
           # z, sigma, rgb in; norms and cotangents in; d sigma, d rgb and
           # d sem out (the semantics themselves are not needed)
           N_RAYS * t * (8 + 12) + N_RAYS * 4 * (1 + 3 + c + 1)
           + N_RAYS * t * 4 * (1 + 3 + c),
           # per sample: ~30 for the weight, its backward scan and dw, one
           # product per d rgb and d sem element
           N_RAYS * t * (30 + 3 + c),
           "ucsa_neural_rendering_tpu/ops/compositing.py:16",
           "ucsa_neural_rendering_tpu_torch/csrc/composite_bwd.cu",
           f"([{N_RAYS},{t}], C={c}; d sigma max_abs_err {errs[0]:.3e})")

    # hash_encode_sampled on one refresh chunk: 262,144 jittered probes of
    # x-slab 0 of the 128³ grid
    r = grid.shape[0]
    m = 262144
    flat = torch.arange(m, device=device)
    cells = torch.stack([flat // (r * r), (flat // r) % r, flat % r],
                        -1).float()
    xyz = (cells + torch.rand((m, 3), generator=gen, device=device)) / r \
        * (2.0 * bound) - bound
    p01 = ((xyz + bound) / (2.0 * bound)).contiguous()
    tb = model.encoder.table_bf16()
    hk = he.hash_encode_sampled(tb, p01, spec)
    hp = he.hash_encode_sampled_plain(tb, p01, spec)
    torch.cuda.synchronize()
    assert torch.equal(hk, hp)  # the same corner, then a copy of its row
    rows = torch.unique(he.sampled_corner_indices(p01, spec)).numel()
    record("hash_encode_sampled", 0.0,
           lambda: he.hash_encode_sampled(tb, p01, spec),
           lambda: he.hash_encode_sampled_plain(tb, p01, spec),
           # points in, features out, each distinct drawn row read once
           m * 12 + m * L * F * 2 + rows * F * 2,
           # per (point, level): 3 frac, 8 × 4 for the weights and cdf, ~12
           # hash ops, ~12 for the uniform
           m * L * (3 + 32 + 12 + 12),
           "ucsa_neural_rendering_tpu/models/hash_encoding.py:456",
           "ucsa_neural_rendering_tpu_torch/csrc/hash_encode_sampled.cu",
           f"([{m},3] → [{m},{L * F}], {rows} distinct rows)")

    # occ_grid_update at 128³ with one slab (of 4) of fresh densities
    n_slab = r ** 3 // 4
    fresh = 30.0 * torch.rand((n_slab,), generator=gen, device=device)
    for slab in range(4):
        a = oc.occ_grid_update(grid, fresh, slab * n_slab, 0.62)
        b = oc.occ_grid_update_plain(grid, fresh, slab * n_slab, 0.62)
        torch.cuda.synchronize()
        assert torch.equal(a, b)  # one multiply and one max per cell
    record("occ_grid_update", 0.0,
           lambda: oc.occ_grid_update(grid, fresh, n_slab, 0.62),
           lambda: oc.occ_grid_update_plain(grid, fresh, n_slab, 0.62),
           # the grid in and out once, the slab's densities in once
           r ** 3 * 8 + n_slab * 4, r ** 3 + n_slab,
           "ucsa_neural_rendering_tpu/ops/occupancy.py:99",
           "ucsa_neural_rendering_tpu_torch/csrc/occ_grid_update.cu",
           f"({r}³, slab of {n_slab})")
    kernels.reset_launches()  # the comparisons above are not the main path


def mlp_work(dims, n, backward):
    """(bytes, operations) of one MLP call on n points. Forward: x in, y
    out, the f32 weights once; 2·n·Σ d_l·d_{l+1}. Backward: x and dy in, dx
    out, the weights in and dW out; the hidden forward once, then dW and dh
    per layer."""
    pairs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    if backward:
        return (n * (2 * dims[0] + dims[-1]) * 2 + 8 * sum(pairs),
                2 * n * (sum(pairs[:-1]) + 2 * sum(pairs)))
    return n * (dims[0] + dims[-1]) * 2 + 4 * sum(pairs), 2 * n * sum(pairs)


def _mlp_rows_err(out, ref):
    """max |diff|; asserts it is within two bf16 ulps of each row's largest
    |value| and that at least 0.98 of the elements are bit-equal (the
    tensor cores and cuBLAS sum in other orders and round an element to the
    other neighbour now and then; a hidden value that did so moves the next
    layer's outputs by a fraction of an ulp of the row)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    scale = ref.abs().amax(-1, keepdim=True)
    assert torch.isfinite(out).all()
    assert (diff <= 2.0 ** -7 * scale).all(), (diff / scale).max().item()
    equal = (diff == 0).float().mean().item()
    assert equal >= 0.98, equal
    return diff.max().item(), equal


def check_mlp_kernels(model, cfgs, device, rec):
    """Phase 3, MLPs: mlp_fwd and mlp_bwd against their plain versions for
    the sigma, color and semantics MLPs at the numbers of points the paths
    give them: a training step's (sigma 4096 × 24 and × 8, color and
    semantics 4096 × 32), a render chunk's (4096 × 16) and, forward only, a
    refresh chunk's (sigma, 262,144). The semantics MLP reads its input as
    a column slice of a 16-wide tensor, as the paths do. The records sum
    the training step's four calls."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as sn

    cfg = train_config()
    gen = torch.Generator(device).manual_seed(11)
    nets = {"sigma": model.sigma_net, "color": model.color_net,
            "semantics": model.semantics_net}
    step = [("sigma", N_RAYS * cfg.num_steps),
            ("sigma", N_RAYS * cfg.upsample_steps),
            ("color", N_RAYS * (cfg.num_steps + cfg.upsample_steps)),
            ("semantics", N_RAYS * (cfg.num_steps + cfg.upsample_steps))]
    calls = [(net, n, "step", True) for net, n in step]
    render = []
    for c in cfgs.values():
        # stage 1: every ray of the chunk through all three MLPs; the
        # refine pass: sigma on its coarse and on its new samples, color
        # and semantics on the merged ones
        k = max(1, int(round(c.max_ray_batch * c.refine_fraction)))
        render += [(net, c.max_ray_batch * c.stage1_steps) for net in nets]
        render += [("sigma", k * c.num_steps), ("sigma", k * c.upsample_steps),
                   ("color", k * (c.num_steps + c.upsample_steps)),
                   ("semantics", k * (c.num_steps + c.upsample_steps))]
    calls += [(net, n, "render", False) for net, n in dict.fromkeys(render)]
    calls.append(("sigma", 262144, "refresh", False))

    shapes = {"mlp_fwd": [], "mlp_bwd": []}
    for net, n, where, bwd in calls:
        ws = [lin.weight.detach() for lin in nets[net].layers]
        dims = [ws[0].shape[1]] + [w.shape[0] for w in ws]
        x = torch.randn((n, dims[0] + (net == "semantics")), generator=gen,
                        device=device).to(torch.bfloat16)
        x = x[:, 1:] if net == "semantics" else x
        err, equal = _mlp_rows_err(sn.mlp_fwd(x, ws), sn.mlp_fwd_plain(x, ws))
        n_bytes, n_ops = mlp_work(dims, n, False)
        todo = [("mlp_fwd", err, equal, lambda: sn.mlp_fwd(x, ws),
                 lambda: sn.mlp_fwd_plain(x, ws),
                 lambda: sn.mlp_fwd_plain(x, ws), n_bytes, n_ops)]
        if bwd:
            dy = torch.randn((n, dims[-1]), generator=gen, device=device
                             ).to(torch.bfloat16)
            dx, dws = sn.mlp_bwd(x, ws, dy)
            rdx, rdws = sn.mlp_bwd_plain(x, ws, dy)
            err, equal = _mlp_rows_err(dx, rdx)
            for dw, ref in zip(dws, rdws):
                # f32 sums over n points in another order, rounded to bf16
                # once: an ulp of the element, plus 2^-12 of the layer's
                # largest |value| for sums that cancel to near zero
                tol = 2.0 ** -7 * ref.abs() + 2.0 ** -12 * ref.abs().max()
                assert ((dw - ref).abs() <= tol).all(), (net, n)
                err = max(err, (dw - ref).abs().max().item())
            leaves = [t.detach().requires_grad_() for t in (x, *ws)]

            def library(leaves=leaves, dy=dy):
                with torch.enable_grad():
                    y = sn.mlp_fwd_plain(leaves[0], leaves[1:])
                    return torch.autograd.grad(y, leaves, dy)

            n_bytes, n_ops = mlp_work(dims, n, True)
            todo.append(("mlp_bwd", err, equal,
                         lambda x=x, dy=dy: sn.mlp_bwd(x, ws, dy),
                         lambda x=x, dy=dy: sn.mlp_bwd_plain(x, ws, dy),
                         library, n_bytes, n_ops))
        for name, err, equal, fn_k, fn_p, fn_lib, n_bytes, n_ops in todo:
            # mlp_bwd's two device operations apart: the main kernel and
            # the cross-block dW reduction
            parts = device_ms(fn_k, by_name=True)
            reduce_ms = sum(v for k, v in parts.items() if "reduce" in k)
            r = dict(net=net, n=n, where=where, max_abs_err=err,
                     bit_equal=equal, ms=sum(parts.values()),
                     plain_ms=device_ms(fn_p, iters=5, warmup=1),
                     library_ms=device_ms(fn_lib, iters=5, warmup=1),
                     bytes=n_bytes, ops=n_ops,
                     bound_ms=bound_ms(n_bytes, n_ops, BF16_OPS_PER_S))
            split = ""
            if name == "mlp_bwd":
                r.update(kernel_ms=r["ms"] - reduce_ms, reduce_ms=reduce_ms)
                split = (f" = kernel {r['kernel_ms']:.4f} + dW reduction "
                         f"{reduce_ms:.4f}")
            shapes[name].append(r)
            first = first_version(name, f"{where} {net} {n}")
            log(f"  {name} {net} {dims} N={n} ({where}): max_abs_err "
                f"{err:.3e} (bit-equal {equal:.4f})  kernel {r['ms']:.4f} "
                f"ms{split} (first version: {first})  plain "
                f"{r['plain_ms']:.4f}  library {r['library_ms']:.4f}  bound "
                f"{r['bound_ms']:.4f} ms")
    for name, rows in shapes.items():
        in_step = [r for r in rows if r["where"] == "step"]
        n_bytes = sum(r["bytes"] for r in in_step)
        n_ops = sum(r["ops"] for r in in_step)
        rec[name] = dict(
            name=name, route="cuda",
            source=f"ucsa_neural_rendering_tpu_torch/csrc/{name}.cu",
            replaces="ucsa_neural_rendering_tpu/models/semantic_nerf.py:28",
            max_abs_err=max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] for r in in_step)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=bound_by(n_bytes, n_ops, BF16_OPS_PER_S), shapes=rows)
        split = ""
        if name == "mlp_bwd":
            rec[name].update({k: sum(r[k] for r in in_step)
                              for k in ("kernel_ms", "reduce_ms")})
            split = (f" = kernel {rec[name]['kernel_ms']:.4f} + dW reduction "
                     f"{rec[name]['reduce_ms']:.4f}")
        log(f"  {name}, one training step's {len(in_step)} calls: kernel "
            f"{rec[name]['ms']:.4f} ms{split}  plain "
            f"{rec[name]['plain_ms']:.4f}  library "
            f"{rec[name]['library_ms']:.4f}  bound "
            f"{rec[name]['bound_ms']:.4f} ms ({rec[name]['bound_by']})")
    kernels.reset_launches()  # the comparisons above are not the main path


@torch.no_grad()
def check_gather(device):
    """Phase 3, row gather: dma_gather against torch.index_select at the
    benchmark's shapes, bit-equal (a copy) at every row width."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
    for f, dtype in bg.ROW_WIDTHS:
        table, idx = bg.gather_inputs(bg.T_ROWS, bg.M_ROWS, f, dtype, device)
        assert torch.equal(bg.dma_gather(table, idx),
                           bg.dma_gather_plain(table, idx)), (f, dtype)
        log(f"  dma_gather {dtype} F={f} [{bg.T_ROWS}] x {bg.M_ROWS}: "
            f"bit-equal to index_select")
    kernels.reset_launches()  # the comparisons above are not the main path


def gather_phase(rec):
    """Phase 6: the gather benchmark's entry point, counts zeroed before and
    read after. The record is its 256-byte rows (bf16 F = 128), with the
    faster of index_select and table[idx] as library_ms; every width goes to
    chip_smoke.json."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
    kernels.reset_launches()
    rows = bg.main([])
    launches = kernels.LAUNCHES["dma_gather"]
    assert launches > 0 and all(r["equal"] for r in rows)
    for r in rows:
        # indices read once, rows written once, each distinct row read once
        r["bytes"] = r["m"] * (4 + r["row_bytes"]) \
            + r["distinct_rows"] * r["row_bytes"]
        r["bound_ms"] = bound_ms(r["bytes"], 0)
        r["bound_ns_per_row"] = r["bound_ms"] * 1e6 / r["m"]
        log(f"  row {r['row_bytes']} B: bound {r['bound_ns_per_row']:.4f} "
            f"ns/row ({r['distinct_rows']} distinct rows)")
    wide = rows[-1]
    rec["dma_gather"] = dict(
        name="dma_gather", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/dma_gather.cu",
        replaces="scripts/bench_dma_gather.py:156", launches=launches,
        max_abs_err=0.0, ms=wide["ms"], plain_ms=wide["index_select_ms"],
        bound_ms=wide["bound_ms"], bound_by="bytes",
        library_ms=min(wide["index_select_ms"], wide["index_ms"]),
        widths=rows)
    return launches


# ------------------------------------------------------------- main path
def timed(fn):
    """(fn(), its host ms), the clock read after synchronising the card
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def render_phase(model, grid, cfgs, device, frames):
    """Phase 4: full-frame renders through NeRFTrainer.render_image: the
    kernel path, the same frames with only the MLP kernels plain (timed
    only), then the plain path (held to the kernel path)."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    H, W = 240, 320
    poses = [look_at(POSES[i % len(POSES)]) for i in range(frames)]
    rays = [get_rays(p, INTRINSICS, H, W, device=device) for p in poses]
    trainers = {name: NeRFTrainer(model, cfg, image_hw=(H, W), device=device)
                for name, cfg in cfgs.items()}
    # warm-up frame per config (allocator, cuBLAS handles): not counted
    for tr in trainers.values():
        tr.render_image(None, poses[0], INTRINSICS, rays[0], grid)
    torch.cuda.synchronize()

    # the kernel path and, for its frame time, the same frames with only
    # the MLP kernels plain (torch.matmul chains), in turns (kernel, MLP
    # plain, MLP plain, kernel, ...) so that drifts of the host's speed
    # within the call fall on both; the counts are zeroed just before each
    # kernel-path frame and read just after
    outs, frame_ms, mlp_plain_ms, per_cfg = {}, {}, {}, {}
    for name, tr in trainers.items():
        frame_ms[name], mlp_plain_ms[name] = [], []
        per_cfg[name] = dict.fromkeys(kernels.LAUNCHES, 0)
        for i in range(frames):
            frame = lambda: tr.render_image(None, poses[i], INTRINSICS,
                                            rays[i], grid)
            for kernel_path in ((True, False) if i % 2 == 0 else
                                (False, True)):
                if kernel_path:
                    kernels.reset_launches()
                    outs[name, i], ms = timed(frame)
                    for k, v in kernels.LAUNCHES.items():
                        per_cfg[name][k] += v
                    frame_ms[name].append(ms)
                else:
                    kernels.reset_launches()
                    with kernels.plain_versions(*MLP_KERNELS):
                        mlp_plain_ms[name].append(timed(frame)[1])
                    assert kernels.LAUNCHES["mlp_fwd"] == 0, kernels.LAUNCHES
    launches = {k: sum(c[k] for c in per_cfg.values())
                for k in kernels.LAUNCHES}

    results = {}
    kernels.reset_launches()
    for name, tr in trainers.items():
        plain_times, agree = [], []
        for i in range(frames):
            with kernels.plain_versions():
                ref, ms = timed(lambda: tr.render_image(
                    None, poses[i], INTRINSICS, rays[i], grid))
            plain_times.append(ms)
            out = outs[name, i]
            assert out["nerf_rgb"].shape == (H, W, 3)
            assert out["nerf_semantics_raw"].shape == (H, W,
                                                       model.num_semantic_classes)
            for k in ("nerf_rgb", "nerf_semantics_raw", "nerf_depth"):
                assert torch.isfinite(out[k]).all(), k
            rgb_d = (out["nerf_rgb"] - ref["nerf_rgb"]).abs()
            dep_d = (out["nerf_depth"] - ref["nerf_depth"]).abs()
            labels = (out["nerf_semantics"] == ref["nerf_semantics"]
                      ).float().mean().item()
            agree.append(dict(rgb_max=rgb_d.max().item(),
                              rgb_mean=rgb_d.mean().item(),
                              depth_max=dep_d.max().item(),
                              depth_mean=dep_d.mean().item(),
                              labels=labels))
        per_frame = {k: v / frames for k, v in per_cfg[name].items() if v}
        results[name] = dict(ms_per_frame=frame_ms[name],
                             mlp_plain_ms_per_frame=mlp_plain_ms[name],
                             plain_ms_per_frame=plain_times,
                             launches=per_cfg[name],
                             launches_per_frame=per_frame, agreement=agree)
        log(f"  {name}: ms/frame kernel {[round(t, 2) for t in frame_ms[name]]}"
            f" MLP kernels plain {[round(t, 2) for t in mlp_plain_ms[name]]}"
            f" plain {[round(t, 2) for t in plain_times]}")
        log(f"  {name}: launches per frame {per_frame}")
        for i, a in enumerate(agree):
            log(f"  {name} frame {i}: " + " ".join(
                f"{k} {v:.3e}" for k, v in a.items()))
            # kernel vs plain on the card: the same arithmetic up to f32
            # summation order, bf16 matmul tiling and near-tie decisions
            # (top-K, w > 1e-4 mask, inverse-CDF bins) on a few rays
            assert a["labels"] >= 0.99, a
            assert a["rgb_mean"] <= 1e-3 and a["depth_mean"] <= 1e-2, a
    # the reference renders ran no kernel
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    return launches, results, trainers, outs


def _level_sums(grad, spec):
    """Per level: the [F] sums of the table gradient and its L1 mass."""
    sums, mass = [], []
    for lvl in range(spec.n_levels):
        rows = grad[spec.offsets[lvl]:spec.offsets[lvl] + spec.sizes[lvl]]
        sums.append(rows.double().sum(0))
        mass.append(rows.double().abs().sum())
    return torch.stack(sums), torch.stack(mass)


def train_phase(targets, device, steps, seed, out_dir):
    """Phase 5: `steps` NeRFTrainer.train_steps of a fresh shipped-config
    model on the kernel path, then with only the MLP kernels plain, then on
    the plain path, each from the same init and generator seed;
    update_occupancy after every 16th step."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    intr = torch.tensor(INTRINSICS, device=device)
    batches = [{"pose": torch.as_tensor(look_at(POSES[i % len(POSES)]),
                                        device=device),
                "intrinsics": intr, "image": out["nerf_rgb"],
                "label": out["nerf_semantics"], "depth": out["nerf_depth"],
                "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
               for i, out in enumerate(targets)]

    def make_trainer(render_cfg):
        """A fresh model's trainer; render_cfg None takes the trainer's
        default RenderConfig()."""
        model = SemanticNeRF(**TRAIN_MODEL, device=device,
                             generator=torch.Generator().manual_seed(seed))
        tr = NeRFTrainer(model, render_cfg, n_rays=N_RAYS,
                         image_hw=(240, 320), device=device)
        tr.init()
        return tr

    def run(tr, res, n_steps=steps, plain=None):
        """Steps tr n_steps times (update_occupancy after every 16th), one
        step and its refresh per next(), inside kernels.plain_versions(
        *plain) when plain is given (() swaps every kernel), filling res:
        losses, host ms, step 1's level sums, and the launches of the steps
        and of the refreshes (counts zeroed just before each, read just
        after)."""
        ctx = (contextlib.nullcontext if plain is None
               else lambda: kernels.plain_versions(*plain))
        gen = torch.Generator(device).manual_seed(seed + 1)
        grid = tr.init_occupancy()
        res.update(losses=[], step_ms=[], refresh_ms=[],
                   launches=dict.fromkeys(kernels.LAUNCHES, 0),
                   refresh_launches=dict.fromkeys(kernels.LAUNCHES, 0))
        for i in range(n_steps):
            with ctx():
                kernels.reset_launches()
                parts, ms = timed(lambda: tr.train_step(
                    batches[i % len(batches)], gen, grid))
                for k, v in kernels.LAUNCHES.items():
                    res["launches"][k] += v
                res["step_ms"].append(ms)
                if (i + 1) % tr.occ_cfg.update_every == 0:
                    kernels.reset_launches()
                    grid, ms = timed(lambda: tr.update_occupancy(grid, gen))
                    for k, v in kernels.LAUNCHES.items():
                        res["refresh_launches"][k] += v
                    res["refresh_ms"].append(ms)
            if i == 0:
                res["sums"] = _level_sums(tr.model.encoder.table.grad,
                                          tr.model.encoder.spec)
            res["losses"].append({k: v.item() for k, v in parts.items()})
            res.update(grid=grid, gen=gen)
            yield

    def drive(*runs):
        """Advance the runs in turns, one step each, to their ends."""
        for _ in itertools.zip_longest(*runs):
            pass

    # the kernel path and, in turns with it, the same steps with only the
    # MLP kernels plain (torch.matmul chains and their step-by-step
    # backward): what the MLP kernels contribute to the agreement and to
    # the step time
    shipped = train_config()
    tr = make_trainer(shipped)
    kern, mlp_plain = {}, {}
    drive(run(tr, kern), run(make_trainer(shipped), mlp_plain,
                             plain=MLP_KERNELS))
    in_refresh = kern["refresh_launches"]
    launches = {k: v + in_refresh[k] for k, v in kern["launches"].items()}
    missing = [k for k, v in launches.items() if v <= 0 and k != "dma_gather"]
    assert not missing, f"kernels not launched on the training path: {missing}"
    assert in_refresh["mlp_fwd"] > 0 and in_refresh["hash_encode_sampled"] > 0
    assert launches["mlp_bwd"] > 0 and in_refresh["mlp_bwd"] == 0
    assert not any(mlp_plain["launches"][k] + mlp_plain["refresh_launches"][k]
                   for k in MLP_KERNELS), mlp_plain

    # step 1 once more with only the two backward kernels' plain versions:
    # the same forward bit for bit, so the table gradient differs by the
    # order of the atomics and composite_bwd's scan alone
    bwd_plain, plain = {}, {}
    drive(run(make_trainer(shipped), bwd_plain, 1,
              plain=("hash_encode_bwd", "composite_bwd")))
    drive(run(make_trainer(shipped), plain, plain=()))
    assert not any(plain["launches"].values()), plain["launches"]
    assert not any(plain["refresh_launches"].values())

    def sum_err(a, b):
        """max over levels of max |Δ per-feature sum| / the level's mass"""
        return ((a[0] - b[0]).abs().amax(-1) / b[1]).max().item()

    def loss_err(a, b):
        return max(abs(a[k] - b[k]) / abs(b[k]) for k in a)

    total = [s["loss_nerf_total"] for s in kern["losses"]]
    first_k, first_p = kern["losses"][0], plain["losses"][0]
    err_loss = loss_err(first_k, first_p)
    err_loss_mlp = loss_err(first_k, mlp_plain["losses"][0])
    err_plain = sum_err(kern["sums"], plain["sums"])
    err_bwd = sum_err(kern["sums"], bwd_plain["sums"])
    err_mlp = sum_err(kern["sums"], mlp_plain["sums"])
    last8 = sum(total[-8:]) / 8
    log(f"  step 1 losses kernel {first_k} plain {first_p}: max rel diff "
        f"{err_loss:.3e} (against MLP kernels plain only {err_loss_mlp:.3e})")
    log(f"  step 1 per-level gradient sums, max |diff| / level mass: "
        f"against the plain path {err_plain:.3e}, against plain backward "
        f"kernels only {err_bwd:.3e}, against plain MLP kernels only "
        f"{err_mlp:.3e}")
    log(f"  total loss step 1 {total[0]:.5f}, mean of the last 8 steps "
        f"{last8:.5f}; every 4th step {[round(t, 5) for t in total[::4]]}")
    for s in kern["losses"] + mlp_plain["losses"] + plain["losses"]:
        assert all(math.isfinite(v) for v in s.values()), s
    # step 1, the same parameters and draws: the paths differ only in
    # summation order (placement, compositing, the MLPs' products) and
    # atomics. With only the MLP kernels plain the paths run the same
    # kernels but the MLPs, which differ from cuBLAS by a bf16 ulp on ~1e-4
    # of the elements: 1e-5 (readings 0 on the loss, 1.9e-7 on the level
    # sums).
    assert err_loss <= 2e-3 and err_loss_mlp <= 1e-5, (err_loss, err_loss_mlp)
    # per level, the table gradient's sums do not depend on which corner a
    # point's last position bits draw. Against the plain path: within 5e-4
    # of the level's L1 mass — the placements' inverse CDFs sum in another
    # order and move some samples by up to ~3e-4 scene units, a third of
    # the finest cell (8 / 8192), which changes those points' features and
    # so their cotangents. With only the backward kernels plain, or only
    # the MLP kernels: 1e-5 (f32 atomics order, or an MLP ulp; a 1e-5
    # change of d sigma flips a bf16 rounding of the cotangent on a few
    # elements).
    assert err_plain <= 5e-4, err_plain
    assert err_mlp <= 1e-5, err_mlp
    assert err_bwd <= 1e-5, err_bwd
    assert last8 < total[0], (total[0], last8)

    # the trainer's default RenderConfig() (256 coarse + 256 fine samples a
    # ray, so composite_bwd runs over 512): a few steps
    # on the kernel path in turns with the plain path, from the same init
    # and draws, held to the step-1 limits above
    dflt, dflt_plain = {}, {}
    drive(run(make_trainer(None), dflt, DEFAULT_CFG_STEPS),
          run(make_trainer(None), dflt_plain, DEFAULT_CFG_STEPS, plain=()))
    missing = [k for k, v in dflt["launches"].items()
               if v <= 0 and k not in ("dma_gather", "occ_grid_update",
                                       "hash_encode_sampled")]
    assert not missing, f"default config: kernels not launched: {missing}"
    assert not any(dflt_plain["launches"].values()), dflt_plain["launches"]
    for s in dflt["losses"] + dflt_plain["losses"]:
        assert all(math.isfinite(v) for v in s.values()), s
    dflt_loss = loss_err(dflt["losses"][0], dflt_plain["losses"][0])
    dflt_sums = sum_err(dflt["sums"], dflt_plain["sums"])
    log(f"  default RenderConfig() (256 + 256 samples), {DEFAULT_CFG_STEPS} "
        f"steps: step 1 losses max rel diff {dflt_loss:.3e}, level sums "
        f"{dflt_sums:.3e}; ms/step kernel "
        f"{[round(t, 2) for t in dflt['step_ms']]} plain "
        f"{[round(t, 2) for t in dflt_plain['step_ms']]}")
    assert dflt_loss <= 2e-3 and dflt_sums <= 5e-4, (dflt_loss, dflt_sums)

    n_refresh = len(kern["refresh_ms"])
    per_step = {k: v / steps for k, v in kern["launches"].items() if v}
    per_refresh = {k: v / n_refresh for k, v in in_refresh.items() if v}
    med = statistics.median(kern["step_ms"])
    med_mlp = statistics.median(mlp_plain["step_ms"])
    log(f"  ms/step kernel median {med:.2f} (all {[round(t, 2) for t in kern['step_ms']]})")
    log(f"  ms/step MLP kernels plain median {med_mlp:.2f}; plain median "
        f"{statistics.median(plain['step_ms']):.2f}")
    log(f"  rays/s {N_RAYS / med * 1e3:.1f} (MLP kernels plain "
        f"{N_RAYS / med_mlp * 1e3:.1f}); ms/refresh kernel "
        f"{[round(t, 2) for t in kern['refresh_ms']]} MLP kernels plain "
        f"{[round(t, 2) for t in mlp_plain['refresh_ms']]} plain "
        f"{[round(t, 2) for t in plain['refresh_ms']]}")
    log(f"  launches per step {per_step}; per refresh {per_refresh}")

    step_fn = lambda: tr.train_step(batches[0], kern["gen"], kern["grid"])
    table, busy = profile_run(step_fn, out_dir, "profile_train_step.txt")
    log("\n".join(table.splitlines()[:16]))
    busy["idle_share_unprofiled"] = 1.0 - busy["device_busy_ms"] / med
    with kernels.plain_versions(*MLP_KERNELS):
        _, busy_mlp = profile_run(step_fn, out_dir,
                                  "profile_train_step_mlp_plain.txt")
    log(f"  profiled train step: wall {busy['wall_ms']:.2f} ms, device busy "
        f"{busy['device_busy_ms']:.2f} ms, idle share {busy['idle_share']:.3f}"
        f" (against the median unprofiled step "
        f"{busy['idle_share_unprofiled']:.3f}); device-timeline spans, not "
        f"counted: {busy['annotations']}")
    log(f"  device operations per train step: {busy['device_ops']} "
        f"(busy {busy['device_busy_ms']:.3f} ms); with the MLP kernels plain "
        f"{busy_mlp['device_ops']} (busy {busy_mlp['device_busy_ms']:.3f} "
        f"ms)")
    log("  kernels' device ms in the profiled train step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in busy["kernel_ms"].items()))
    result = dict(
        ms_per_step=kern["step_ms"], plain_ms_per_step=plain["step_ms"],
        mlp_plain_ms_per_step=mlp_plain["step_ms"],
        median_ms_per_step=med, rays_per_s=N_RAYS / med * 1e3,
        median_ms_per_step_mlp_plain=med_mlp,
        ms_per_refresh=kern["refresh_ms"],
        mlp_plain_ms_per_refresh=mlp_plain["refresh_ms"],
        plain_ms_per_refresh=plain["refresh_ms"],
        launches=launches, launches_per_step=per_step,
        launches_per_refresh=per_refresh, losses=kern["losses"],
        mlp_plain_losses=mlp_plain["losses"],
        plain_losses=plain["losses"], step1_loss_rel_err=err_loss,
        step1_loss_rel_err_mlp=err_loss_mlp,
        step1_level_sum_err=err_plain, step1_level_sum_err_bwd=err_bwd,
        step1_level_sum_err_mlp=err_mlp,
        profiled_step=busy, profiled_step_mlp_plain=busy_mlp,
        default_cfg=dict(ms_per_step=dflt["step_ms"],
                         plain_ms_per_step=dflt_plain["step_ms"],
                         losses=dflt["losses"],
                         plain_losses=dflt_plain["losses"],
                         step1_loss_rel_err=dflt_loss,
                         step1_level_sum_err=dflt_sums,
                         launches=dflt["launches"]))
    return launches, result


def profile_run(fn, out_dir, name):
    """Device time by kernel name over one call of fn (torch.profiler), the
    device's busy time against the call's wall time: the sum of the
    device-side events' durations (one stream, so they do not overlap), and
    the number of those events (kernels, copies and fills).
    User annotations on the device timeline (the optimizer's
    `Optimizer.step#...` range) span other events and the gaps between
    them: they are left out of the sum and reported apart. kernel_ms sums
    the device time of each of the port's kernels (mlp_bwd's dW reduction
    with it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ucsa_neural_rendering_tpu_torch import kernels
    symbols = {k: (f"{k}_kernel",) for k in kernels.LAUNCHES}
    symbols["mlp_bwd"] += ("mlp_dw_reduce_kernel",)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in device if e.is_user_annotation]
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in device
                         if not e.is_user_annotation)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=45)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table)
    kernel_ms = {k: 1e-3 * sum(e.time_range.elapsed_us() for e in device
                               if any(sym in e.name for sym in syms))
                 for k, syms in symbols.items()}
    return table, dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_ops=sum(not e.is_user_annotation for e in device),
        idle_share=1.0 - busy_ms / wall_ms,
        annotations={e.name: 1e-3 * e.time_range.elapsed_us() for e in spans},
        kernel_ms={k: v for k, v in kernel_ms.items() if v})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--steps", type=int, default=32,
                    help="training steps per path (phase 5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and the profile table")
    args = ap.parse_args()

    # phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ucsa_neural_rendering_tpu_torch import kernels
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    assert smi.returncode == 0, smi.stderr
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    secs = kernels.build()
    log(f"phase 2: built {len(kernels.SIGNATURES)} kernels in {secs:.1f} s")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3
    log("phase 3: kernels against their plain versions")
    model, grid = make_scene(device, args.seed)
    cfgs = render_configs()
    rec = check_kernels(model, grid, cfgs, device)
    check_train_kernels(model, grid, device, rec)
    check_mlp_kernels(model, cfgs, device, rec)
    check_gather(device)
    if args.quick:
        log(json.dumps({"kernels": list(rec.values())}))
        return 0

    # phase 4
    log(f"phase 4: {args.frames} frames of 240x320 per config")
    launches, results, trainers, outs = render_phase(model, grid, cfgs,
                                                     device, args.frames)
    missing = [k for k in RENDER_KERNELS if launches[k] <= 0]
    assert not missing, f"kernels not launched on the render path: {missing}"
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    rays0 = get_rays(look_at(POSES[0]), INTRINSICS, 240, 320, device=device)
    frame_fn = lambda: trainers["test"].render_image(None, None, INTRINSICS,
                                                     rays0, grid)
    table, busy = profile_run(frame_fn, args.out, "profile_test_frame.txt")
    log("\n".join(table.splitlines()[:16]))
    # the profiler's own host cost stretches the profiled frame; the same
    # frame (pose 0, test config) unprofiled took ms_per_frame[0]
    busy["idle_share_unprofiled"] = 1.0 - (
        busy["device_busy_ms"] / results["test"]["ms_per_frame"][0])
    with kernels.plain_versions(*MLP_KERNELS):
        _, busy_mlp = profile_run(frame_fn, args.out,
                                  "profile_test_frame_mlp_plain.txt")
    log(f"  profiled test frame: wall {busy['wall_ms']:.2f} ms, device busy "
        f"{busy['device_busy_ms']:.2f} ms, idle share "
        f"{busy['idle_share']:.3f} (against the unprofiled frame "
        f"{busy['idle_share_unprofiled']:.3f})")
    log(f"  device operations per test frame: {busy['device_ops']} (busy "
        f"{busy['device_busy_ms']:.3f} ms); with the MLP kernels plain "
        f"{busy_mlp['device_ops']} (busy {busy_mlp['device_busy_ms']:.3f} "
        f"ms)")
    log("  kernels' device ms in the profiled test frame: " + ", ".join(
        f"{k} {v:.4f}" for k, v in busy["kernel_ms"].items()))

    # phase 5
    log(f"phase 5: {args.steps} training steps per path, {N_RAYS} rays, "
        f"update_occupancy every 16")
    train_launches, train = train_phase(
        [outs["test", i] for i in range(args.frames)], device, args.steps,
        args.seed + 1, args.out)
    for name in rec:
        rec[name]["launches"] = launches[name] + train_launches[name]
        rec[name]["launches_render"] = launches[name]
        rec[name]["launches_train"] = train_launches[name]

    # phase 6
    log("phase 6: the row-gather benchmark")
    gather_phase(rec)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": rec, "render": results,
                   "profiled_test_frame": busy,
                   "profiled_test_frame_mlp_plain": busy_mlp, "train": train},
                  f, indent=1)

    # phase 7
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in rec.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
