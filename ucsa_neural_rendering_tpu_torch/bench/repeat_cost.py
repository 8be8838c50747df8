"""The cost of repeating on the card: the port's training paths with their
fixed-order forms against the forms they replaced, in turns in one process
(earlier, this, this, earlier, ...):

  bwd     hash_encode_bwd at the shipped step's 131,072 points (8 × 4: exact,
          stochastic, face) and the dense step's 2,097,152 (16 × 2:
          stochastic, exact): this tree's kernel (a sort by row, then each
          row's sum in a fixed order) against an earlier version's
          (--first-version DIR, e.g. the parent commit's `csrc` from git
          archive, whose kernel adds with f32 atomics into a zeroed
          gradient), each held to the plain version;
  resize  the seg net's bilinear resize, forward + backward, as matrix
          products (this tree) against F.interpolate (the earlier form, and
          the library call), at the DeepLab shape (4 × 40 channels,
          30 × 40 → 240 × 320) and the gate's (15 × 20 → 120 × 160);
  nerf    the shipped NeRF step (4096 rays, 24 + 8 samples, the card's
          packing defaults), device ms, with each hash_encode_bwd;
  seg     a DeepLabV3-R101 train step at batch 4, 240 × 320, TF32 on, with
          and without cuDNN's deterministic algorithms (host ms a step);
  joint   a joint step of 4 new frames (the shipped NeRF, R101), device ms,
          with this tree's forms (the sorted hash_encode_bwd, the resize as
          products, the mean pool, cuDNN deterministic) against the earlier
          ones (the atomic kernel, F.interpolate, adaptive_avg_pool2d, cuDNN
          free to pick).

    python -m ucsa_neural_rendering_tpu_torch.bench.repeat_cost \\
        --first-version DIR [--turns N] [--seed S] [--out FILE]

Times are bench.device_ms (profiler device time) but the seg step's (host
ms around a synchronised step, as chip_smoke.py phase 7 times it). It
prints the card's name and power limit, a line a measurement and, last, one
JSON object. It measures the card and raises without one.
"""

import argparse
import contextlib
import copy
import ctypes
import json
import statistics
import time

import torch
import torch.nn.functional as F

from .. import kernels
from ..config import SHIPPED_PROPOSAL, SHIPPED_TRAIN_BUDGET
from ..data.synthetic import make_synthetic_scene
from ..models import DeepLabV3, SemanticNeRF
from ..models import deeplabv3 as dl
from ..models import hash_encoding as he
from ..models.resnet import is_low_precision
from ..ops.renderer import RenderConfig
from ..train import JointTrainer, NeRFTrainer, SegTrainer
from ..utils.device import resolve_device
from . import PROFILES, device_ms
from . import dma_gather as dg

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the earlier kernel's C entry point: x01, g, meta, grad, n_points,
# n_levels, n_features, mode, stream
FIRST_BWD_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# (label, levels, features, samples a ray, modes) at 4096 rays
BWD_SHAPES = (("step", 8, 4, 32, (True, False, "face")),
              ("dense step", 16, 2, 512, (True, False)))
RESIZE_SHAPES = (("deeplab", (4, 40, 30, 40), (240, 320)),
                 ("gate", (4, 40, 15, 20), (120, 160)))
NERF_MODEL = dict(bound=4.0, num_semantic_classes=40, n_levels=8,
                  n_features=4, log2_hashmap_size=19)
JOINT_EXP = {"optimizer": {"lr_seg": 1.0e-5, "lr_nerf": 1.0e-2,
                           "name": "Adam"},
             "nerf": {"use_occupancy": True}}
HW = (240, 320)
SIDES = ("earlier", "this")


def _bound_ms(n_bytes, n_ops):
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def _summary(ms):
    return dict(ms=ms, median_ms=statistics.median(ms), min_ms=min(ms),
                max_ms=max(ms))


def _turns(measure, turns):
    """measure(side) on each side `turns` times, in turns (earlier, this,
    this, earlier, ...). Returns {side: summary}."""
    ms = {s: [] for s in SIDES}
    for t in range(turns):
        for s in (SIDES if t % 2 == 0 else SIDES[::-1]):
            ms[s].append(measure(s))
    return {s: _summary(v) for s, v in ms.items()}


def first_bwd(first_dir):
    """The earlier hash_encode_bwd as a call like he.hash_encode_bwd's: a
    zeroed gradient, then its kernel, built from first_dir's sources."""
    with kernels.sources_from(first_dir, ["hash_encode_bwd"]):
        fn = kernels.entry("hash_encode_bwd", "launch_hash_encode_bwd",
                           FIRST_BWD_SIGNATURE)

    def call(x01, g, spec, stochastic):
        grad = torch.zeros((spec.table_size, spec.n_features),
                           dtype=torch.float32, device=x01.device)
        err = fn(x01.data_ptr(), g.data_ptr(),
                 he._level_meta(spec, x01.device).data_ptr(),
                 grad.data_ptr(), x01.shape[0], spec.n_levels,
                 spec.n_features, he._bwd_mode(stochastic),
                 torch.cuda.current_stream(x01.device).cuda_stream)
        if err:
            raise RuntimeError(f"the earlier hash_encode_bwd: error {err}")
        return grad

    return call


def _interpolate(x, out_hw):
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def _adaptive_pool(self, x):
    if not is_low_precision(x.dtype):
        return F.adaptive_avg_pool2d(x, 1)
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


@contextlib.contextmanager
def earlier_forms(bwd, resize=True):
    """The forms this tree replaced: hash_encode_bwd `bwd`, and with resize
    also F.interpolate, adaptive_avg_pool2d and cuDNN free to pick its
    algorithms."""
    saved = (he.hash_encode_bwd, dl.resize_bilinear,
             dl.GlobalMeanPool.forward, torch.backends.cudnn.deterministic)
    he.hash_encode_bwd = bwd
    if resize:
        dl.resize_bilinear = _interpolate
        dl.GlobalMeanPool.forward = _adaptive_pool
        torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        (he.hash_encode_bwd, dl.resize_bilinear, dl.GlobalMeanPool.forward,
         torch.backends.cudnn.deterministic) = saved


def _ray_points(samples, seed, device):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((4096, 3), generator=g) - 0.5
    d = torch.randn((4096, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(0.0, 0.5, samples)
    x = (o[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)
    return ((x + 1.0) / 2.0).to(device).contiguous()


def measure_bwd(first, turns, seed, device, log):
    rows = []
    for label, levels, features, samples, modes in BWD_SHAPES:
        spec = he.make_spec(levels, features, 19, 16,
                            he.ngp_per_level_scale(4.0, levels))
        x01 = _ray_points(samples, seed, device)
        n = x01.shape[0]
        g = torch.randn((n, spec.out_dim), generator=torch.Generator()
                        .manual_seed(seed + 1)).to(device).bfloat16()
        for stochastic in modes:
            calls = {"earlier": lambda: first(x01, g, spec, stochastic),
                     "this": lambda: he.hash_encode_bwd(x01, g, spec,
                                                        stochastic)}
            ref = he.hash_encode_bwd_plain(x01, g, spec, stochastic)
            mass = he.hash_encode_bwd_plain(x01, g.abs(), spec, stochastic)
            for s, fn in calls.items():
                out = fn()
                assert ((out - ref).abs() <= 1e-5 * mass).all(), (label, s)
            del ref, mass
            t = _turns(lambda s: device_ms(calls[s]), turns)
            n_bytes = n * 12 + n * levels * features * 2 \
                + spec.table_size * features * 4
            row = dict(where=label, points=n, mode=str(stochastic),
                       bound_ms=_bound_ms(n_bytes, 0),
                       parts_ms=device_ms(calls["this"], by_name=True), **t)
            rows.append(row)
            log(f"bwd {label} [{n},3] {levels}x{features} {stochastic}: this "
                f"{t['this']['median_ms']:.4f} ms (spread "
                f"{t['this']['min_ms']:.4f}-{t['this']['max_ms']:.4f}), "
                f"earlier {t['earlier']['median_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f}")
    return rows


def measure_resize(turns, seed, device, log):
    rows = []
    for label, shape, out_hw in RESIZE_SHAPES:
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(shape, generator=g).to(device).requires_grad_(True)
        cot = torch.randn((*shape[:2], *out_hw), generator=g).to(device)
        forms = {"earlier": _interpolate, "this": dl.resize_bilinear}

        def run(s):
            x.grad = None
            forms[s](x, out_hw).backward(cot)

        ref = _interpolate(x, out_hw)
        assert (forms["this"](x, out_hw) - ref).abs().max() <= \
            1e-5 * ref.abs().max()
        t = _turns(lambda s: device_ms(lambda: run(s)), turns)
        b, c, h, w = shape
        big, small = b * c * out_hw[0] * out_hw[1], b * c * h * w
        # x and the output, then the cotangent and dx, 4 B each; the two
        # products each way
        n_bytes = 8 * (big + small)
        n_ops = 4 * (b * c * h * w * out_hw[1] + b * c * out_hw[0] * h
                     * out_hw[1])
        row = dict(where=label, shape=list(shape), out_hw=list(out_hw),
                   bound_ms=_bound_ms(n_bytes, n_ops),
                   bound_by="bytes" if n_bytes / HBM_BYTES_PER_S
                   >= n_ops / F32_OPS_PER_S else "operations", **t)
        rows.append(row)
        log(f"resize {label} {shape} -> {out_hw}, forward + backward: this "
            f"{t['this']['median_ms']:.4f} ms, F.interpolate "
            f"{t['earlier']['median_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
    return rows


def _batches(device):
    frames, intr = make_synthetic_scene(n_frames=4, H=HW[0], W=HW[1])
    intr = torch.as_tensor(intr, device=device)
    return [{"pose": torch.as_tensor(f["pose"], device=device),
             "intrinsics": intr,
             "image": torch.as_tensor(f["image"], device=device),
             "label": torch.as_tensor(f["label"], device=device).long(),
             "depth": torch.as_tensor(f["depth"], device=device),
             "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
            for f in frames], intr


def _train_cfg():
    coarse, fine = SHIPPED_TRAIN_BUDGET
    return RenderConfig(num_steps=coarse, upsample_steps=fine,
                        proposal_placement=SHIPPED_PROPOSAL)


def measure_nerf(first, turns, seed, device, log):
    batches, _ = _batches(device)
    base = NeRFTrainer(SemanticNeRF(**NERF_MODEL, device=device,
                                    generator=torch.Generator()
                                    .manual_seed(seed)),
                       _train_cfg(), n_rays=4096, image_hw=HW, device=device)
    base.init()
    grid = base.init_occupancy()
    draws = base.draw(torch.Generator(device).manual_seed(seed + 1))
    trainers = {s: copy.deepcopy(base) for s in SIDES}

    def step(s):
        ctx = earlier_forms(first, resize=False) if s == "earlier" \
            else contextlib.nullcontext()
        with ctx:
            return device_ms(lambda: trainers[s].train_step(
                batches[0], None, grid, draws=draws), iters=10, warmup=2)

    t = _turns(step, turns)
    # one step of each side by device operation
    for s in SIDES:
        ctx = earlier_forms(first, resize=False) if s == "earlier" \
            else contextlib.nullcontext()
        with ctx:
            t[s]["by_name"] = device_ms(lambda: trainers[s].train_step(
                batches[0], None, grid, draws=draws), iters=5, warmup=1,
                by_name=True)
    names = set(t["this"]["by_name"]) | set(t["earlier"]["by_name"])
    diff = sorted(((t["this"]["by_name"].get(n, 0.0)
                    - t["earlier"]["by_name"].get(n, 0.0), n)
                   for n in names), reverse=True)
    log(f"nerf step: device ms this {t['this']['median_ms']:.4f}, earlier "
        f"hash_encode_bwd {t['earlier']['median_ms']:.4f}; by operation, "
        f"this − earlier: " + "; ".join(f"{n[:60]} {d:+.4f}"
                                        for d, n in diff[:6] + diff[-3:]))
    return t


def measure_seg(turns, seed, device, log, steps=5):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand((4, *HW, 3), generator=g).to(device)
    labels = torch.randint(0, 40, (4, *HW), generator=g).to(device)
    tr = SegTrainer(DeepLabV3(num_classes=40, device=device,
                              generator=torch.Generator().manual_seed(seed)),
                    {"name": "Adam", "lr": 1e-4}, device=device)
    tr.init()
    gen = torch.Generator(device).manual_seed(seed + 1)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False

    def step(s):
        torch.backends.cudnn.deterministic = s == "this"
        tr.train_step(images, labels, 1e-4, gen)
        ms = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(images, labels, 1e-4, gen)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ms)

    t = _turns(step, turns)
    log(f"seg step R101 batch 4 TF32: host ms, median of {steps}: "
        f"deterministic {t['this']['median_ms']:.2f}, free "
        f"{t['earlier']['median_ms']:.2f}")
    return t


def measure_joint(first, turns, seed, device, log):
    batches, intr = _batches(device)
    new = {"img": torch.stack([b["image"] for b in batches]),
           "depth": torch.stack([b["depth"] for b in batches]),
           "pose": torch.stack([b["pose"] for b in batches]),
           "intrinsics": intr.expand(len(batches), 4),
           "one_m_to_scene_uom": torch.ones(len(batches), device=device)}
    sides = {}
    for s in SIDES:
        jt = JointTrainer(JOINT_EXP, image_hw=HW, num_classes=40,
                          render_cfg=_train_cfg(), n_rays=4096,
                          nerf_model=SemanticNeRF(
                              **NERF_MODEL, device=device,
                              generator=torch.Generator().manual_seed(seed)),
                          seg_model=DeepLabV3(
                              num_classes=40, device=device,
                              generator=torch.Generator()
                              .manual_seed(seed + 1)),
                          device=device)
        jt.init()
        sides[s] = (jt, jt.init_occupancy(),
                    torch.Generator(device).manual_seed(seed + 2))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False

    def step(s):
        jt, grid, gen = sides[s]
        torch.backends.cudnn.deterministic = True
        ctx = earlier_forms(first) if s == "earlier" \
            else contextlib.nullcontext()
        with ctx:
            return device_ms(lambda: jt.joint_step(None, new, None, gen,
                                                   grid), iters=3, warmup=1)

    t = _turns(step, turns)
    log(f"joint step of 4 new frames: device ms this "
        f"{t['this']['median_ms']:.3f}, earlier forms "
        f"{t['earlier']['median_ms']:.3f}")
    return t


def measure(first_dir, device="cuda", turns=4, seed=0, log=print):
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("repeat_cost measures the card")
    first = first_bwd(first_dir)
    res = {"card": dg.card_line()}
    res["bwd"] = measure_bwd(first, turns, seed, device, log)
    res["resize"] = measure_resize(turns, seed, device, log)
    res["nerf_step"] = measure_nerf(first, turns, seed, device, log)
    res["seg_step"] = measure_seg(turns, seed, device, log)
    res["joint_step"] = measure_joint(first, turns, seed, device, log)
    res["profiles"] = dict(PROFILES)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--first-version", required=True,
                   help="a directory of hash_encode_bwd's earlier sources")
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    print(dg.card_line(), flush=True)
    res = measure(args.first_version, "cuda", args.turns, args.seed,
                  log=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
