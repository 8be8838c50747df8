#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ucsa_neural_rendering_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds and renders there.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --out DIR  # where chip_smoke.json and the profile
                                     # table go (default build/chip_smoke)

Phases (any failure exits nonzero; nothing is caught to keep exit code 0):
  1. CUDA present; the card's name and power limit from nvidia-smi.
  2. Build the four CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas reports.
  3. Hold each kernel against its plain PyTorch version on the card, at the
     shapes the render path gives it (both placement modes), with the
     tolerance stated beside each check; time both with CUDA events.
  4. The main path: NeRFTrainer.render_image at full width — Semantic-NeRF
     8 levels × 4 features, 2^19 table, bound 4, 40 classes, seeded random
     weights (table U(-1, 1)) and a seeded 128³ occupancy grid — renders 3
     frames of 240×320 under the test config and 3 under the predict config
     derived from the shipped train budget. Launch counts are zeroed just
     before and read just after; every kernel must have launched. The same
     frames rendered through the plain versions on the card must agree.
  5. One JSON line of per-kernel numbers, then the last line
     {"ok": true, "device": {...}}.

Bounds (bound_ms) are the larger of bytes / 3.35 TB/s and operations / peak
(67 TFLOP/s f32 outside the tensor cores), from the published H100 SXM
figures, with the bytes and operations each kernel's work needs on this
run's inputs (formulas beside each kernel below).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def bound_ms(n_bytes, n_ops):
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def bound_by(n_bytes, n_ops):
    return "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S \
        else "operations"


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device ms per call of fn over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
def check_kernels(model, grid, cfgs, device):
    """Phase 3: each kernel against its plain version at the render path's
    shapes; returns {name: record} with error, times and bound."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import cell_index
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

    def record(name, err, fn_k, fn_p, n_bytes, n_ops, replaces, source,
               extra=""):
        ms = cuda_ms(fn_k)
        plain_ms = cuda_ms(fn_p, iters=5, warmup=1)
        rec[name] = dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=float(err), ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms(n_bytes, n_ops),
                         bound_by=bound_by(n_bytes, n_ops), library_ms=None)
        log(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {rec[name]['bound_ms']:.4f} ms "
            f"({rec[name]['bound_by']}) {extra}")

    # occ_placement: stage-1 shape (4096 rays, 16 samples) in both modes,
    # and the refine pass's coarse shape (1024 rays, 32 samples)
    placement_worst = 0.0
    shapes = [(o, d, test.stage1_steps), (o[:k_refine], d[:k_refine],
                                          test.num_steps)]
    for proposal in (False, True):
        for oo, dd, s in shapes:
            args = (oo, dd, grid, bound, s, test.occ_candidates,
                    test.min_near, proposal, test.occ_floor,
                    test.occ_density_threshold, test.density_scale)
            zk = pl.occ_placement(*args)
            zp = pl.occ_placement_plain(*args)
            torch.cuda.synchronize()
            err = (zk - zp).abs().max().item()
            mean = (zk - zp).abs().mean().item()
            log(f"  occ_placement proposal={proposal} [{oo.shape[0]},{s}]: "
                f"max {err:.3e} mean {mean:.3e}")
            # inverse-CDF: the plain sums run in another order, and a cdf
            # ulp moves z by ulp·width/pdf; z spans up to ~14 scene units
            assert torch.isfinite(zk).all() and err <= 2e-3 and mean <= 1e-5
            assert (zk[:, 1:] >= zk[:, :-1]).all()
            placement_worst = max(placement_worst, err)
    n, s = o.shape[0], test.stage1_steps
    args = (o, d, grid, bound, s, test.occ_candidates, test.min_near, False,
            test.occ_floor, test.occ_density_threshold, test.density_scale)
    z1 = pl.occ_placement(*args)
    # bytes: rays in, z out, and each distinct grid cell the candidates touch
    cand = pl.linspace(0.0, 1.0, test.occ_candidates, device)
    from ucsa_neural_rendering_tpu_torch.ops.aabb import near_far_from_aabb
    nears, fars = near_far_from_aabb(o, d, pl._aabb(bound, device),
                                     test.min_near)
    cz = nears[:, None] + (fars - nears)[:, None] * cand
    cells = torch.unique(cell_index(o[:, None] + d[:, None] * cz[..., None],
                                    bound, grid.shape[0])).numel()
    record("occ_placement", placement_worst,
           lambda: pl.occ_placement(*args), lambda: pl.occ_placement_plain(*args),
           n * 24 + n * s * 4 + cells * 4,
           # ~40 ops per candidate weight, each computed once (the kernel's
           # second pass that recomputes them is its design, not the
           # function's work), ~20 per sample
           n * (test.occ_candidates * 40 + s * 20),
           "ucsa_neural_rendering_tpu/ops/renderer.py:262",
           "ucsa_neural_rendering_tpu_torch/csrc/occ_placement.cu",
           f"(binary, [{n},{s}], {cells} grid cells)")

    # hash_encode_fwd on the stage-1 density call's points (4096 × 16)
    x = _points(o, d, z1, bound)
    x01 = ((x + bound) / (2.0 * bound)).contiguous()
    tb = model.encoder.table_bf16()
    spec = model.encoder.spec
    hk = he.hash_encode(tb, x01, spec)
    hp = he.hash_encode_plain(tb, x01, spec)
    torch.cuda.synchronize()
    diff = (hk.float() - hp.float()).abs()
    # both sum the same exact f32 products in the same order: ≤ 1 bf16 ulp
    assert (diff <= hp.float().abs() * 2.0 ** -7).all()
    rows = sum(torch.unique(he._level_indices(
        x01, spec.resolutions[lv], spec.sizes[lv], spec.hashed[lv])[0]
    ).numel() for lv in range(spec.n_levels))
    npts = x01.shape[0]
    L, F = spec.n_levels, spec.n_features
    record("hash_encode_fwd", diff.max().item(),
           lambda: he.hash_encode(tb, x01, spec),
           lambda: he.hash_encode_plain(tb, x01, spec),
           # points in, features out, each distinct table row read once
           npts * 12 + npts * L * F * 2 + rows * F * 2,
           # per (point, level): 3 frac + 8 corners × (2 weight muls + F
           # multiply-adds + ~6 integer hash ops)
           npts * L * (3 + 8 * (2 + 2 * F + 6)),
           "ucsa_neural_rendering_tpu/models/hash_encoding.py:202",
           "ucsa_neural_rendering_tpu_torch/csrc/hash_encode_fwd.cu",
           f"([{npts},3] → [{npts},{L * F}], {rows} distinct rows)")

    # importance_resample on the refine pass's coarse samples (1024 × 32)
    zc = pl.occ_placement(o[:k_refine], d[:k_refine], grid, bound,
                          test.num_steps, test.occ_candidates, test.min_near,
                          False, test.occ_floor, test.occ_density_threshold,
                          test.density_scale)
    sig, _ = model.density(_points(o[:k_refine], d[:k_refine], zc, bound))
    sig = sig.reshape(k_refine, test.num_steps).contiguous()
    s2 = test.upsample_steps
    nk, zk_all, ok = pl.importance_resample(zc, sig, s2, test.density_scale)
    npl, zp_all, op = pl.importance_resample_plain(zc, sig, s2,
                                                   test.density_scale)
    torch.cuda.synchronize()
    err = max((nk - npl).abs().max().item(),
              (zk_all - zp_all).abs().max().item())
    same_order = (ok == op).all(dim=-1).float().mean().item()
    # inverse-CDF tolerance as for occ_placement; the order must be the
    # stable argsort of the kernel's own merged z, and equal the plain
    # one's on nearly every ray (near-ties may differ)
    assert torch.isfinite(zk_all).all() and err <= 2e-3
    assert torch.equal(torch.take_along_dim(torch.cat([zc, nk], -1), ok, -1),
                       zk_all)
    assert same_order >= 0.98, same_order
    m = s2 + test.num_steps
    record("importance_resample", err,
           lambda: pl.importance_resample(zc, sig, s2, test.density_scale),
           lambda: pl.importance_resample_plain(zc, sig, s2,
                                                test.density_scale),
           # z, sigma in; new z, merged z and the order out, the order at
           # 4 B as JAX's int32 argsort (the int64 the port writes, for
           # take_along_dim, is its design, not the function's)
           k_refine * (test.num_steps * 8 + s2 * 4 + m * 8),
           # each coarse weight once (~10 ops + exp), ~20 per new sample,
           # ~4 per merged sample
           k_refine * (test.num_steps * 12 + s2 * 20 + m * 4),
           "ucsa_neural_rendering_tpu/ops/renderer.py:305",
           "ucsa_neural_rendering_tpu_torch/csrc/importance_resample.cu",
           f"([{k_refine},{test.num_steps}]+{s2}, order equal on "
           f"{same_order:.4f} of rays)")

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


# ------------------------------------------------------------- main path
def render_phase(model, grid, cfgs, device, frames):
    """Phase 4: full-frame renders through NeRFTrainer.render_image, kernel
    path then plain path, on the same frames."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    H, W = 240, 320
    poses = [look_at(POSES[i % len(POSES)]) for i in range(frames)]
    rays = [get_rays(p, INTRINSICS, H, W, device=device) for p in poses]
    trainers = {name: NeRFTrainer(model, cfg, (H, W), device)
                for name, cfg in cfgs.items()}
    # warm-up frame per config (allocator, cuBLAS handles): not counted
    for tr in trainers.values():
        tr.render_image(None, poses[0], INTRINSICS, rays[0], grid)
    torch.cuda.synchronize()

    kernels.reset_launches()
    outs, frame_ms, per_cfg = {}, {}, {}
    for name, tr in trainers.items():
        before = dict(kernels.LAUNCHES)
        times = []
        for i in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name, i] = tr.render_image(None, poses[i], INTRINSICS,
                                            rays[i], grid)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        frame_ms[name] = times
        per_cfg[name] = {k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES}
    launches = dict(kernels.LAUNCHES)

    results = {}
    kernels.reset_launches()
    for name, tr in trainers.items():
        plain_times, agree = [], []
        for i in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with kernels.plain_versions():
                ref = tr.render_image(None, poses[i], INTRINSICS, rays[i],
                                      grid)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
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
        results[name] = dict(ms_per_frame=frame_ms[name],
                             plain_ms_per_frame=plain_times,
                             launches=per_cfg[name], agreement=agree)
        log(f"  {name}: ms/frame kernel {[round(t, 2) for t in frame_ms[name]]}"
            f" plain {[round(t, 2) for t in plain_times]}")
        log(f"  {name}: launches {per_cfg[name]}")
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
    return launches, results, trainers


def profile_frame(trainer, rays, grid, out_dir):
    """Device time by kernel name over one test frame (torch.profiler), and
    the device's busy time against the frame's wall time: the sum of the
    device-side events' durations (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.render_image(None, None, INTRINSICS, rays, grid)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_test_frame.txt"), "w") as f:
        f.write(table)
    return table, dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                       idle_share=1.0 - busy_ms / wall_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--frames", type=int, default=3)
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
    if args.quick:
        log(json.dumps({"kernels": list(rec.values())}))
        return 0

    # phase 4
    log(f"phase 4: {args.frames} frames of 240x320 per config")
    launches, results, trainers = render_phase(model, grid, cfgs, device,
                                               args.frames)
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    for name in rec:
        rec[name]["launches"] = launches[name]
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    table, busy = profile_frame(trainers["test"], get_rays(
        look_at(POSES[0]), INTRINSICS, 240, 320, device=device), grid, args.out)
    log("\n".join(table.splitlines()[:16]))
    # the profiler's own host cost stretches the profiled frame; the same
    # frame (pose 0, test config) unprofiled took ms_per_frame[0]
    busy["idle_share_unprofiled"] = 1.0 - (
        busy["device_busy_ms"] / results["test"]["ms_per_frame"][0])
    log(f"  profiled test frame: wall {busy['wall_ms']:.2f} ms, device busy "
        f"{busy['device_busy_ms']:.2f} ms, idle share "
        f"{busy['idle_share']:.3f} (against the unprofiled frame "
        f"{busy['idle_share_unprofiled']:.3f})")
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": rec, "render": results,
                   "profiled_test_frame": busy}, f, indent=1)

    # phase 5
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
