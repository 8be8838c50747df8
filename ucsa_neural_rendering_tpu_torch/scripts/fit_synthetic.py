"""Quick end-to-end smoke driver: fit a Semantic-NeRF on the procedural cube
room and report PSNR / semantic accuracy (the port's counterpart of
scripts/fit_synthetic.py, the same model, trainer and printed lines). No
data download needed. On the card unless --device cpu:

  python -m ucsa_neural_rendering_tpu_torch.scripts.fit_synthetic \\
      [--steps 120] [--hw 32 40] [--device cpu]

The steps run the dense program (no occupancy grid), as the JAX script's:
the weights drawn from seed 0 and the rays from seed 1, as its keys 0 and
1. A caller holds a run on the card to the kernels' plain versions by
calling main() inside kernels.plain_versions().
"""

import argparse
import time

import numpy as np
import torch

from ..data import get_rays
from ..data.synthetic import make_synthetic_scene
from ..models import SemanticNeRF
from ..ops.renderer import RenderConfig
from ..train import NeRFTrainer
from ..utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--hw", type=int, nargs=2, default=(32, 40))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain PyTorch versions of the kernels)")
    return ap.parse_args(argv)


def build(hw, device):
    """(model, render config, trainer) as the JAX script makes them: 8
    levels, a 2^15 table, bound 1, 6 classes, 48 + 48 samples, 512 rays,
    lr 1e-2; the weights drawn from seed 0."""
    H, W = hw
    model = SemanticNeRF(bound=1.0, num_semantic_classes=6, n_levels=8,
                         log2_hashmap_size=15, device=device,
                         generator=torch.Generator().manual_seed(0))
    cfg = RenderConfig(num_steps=48, upsample_steps=48, max_ray_batch=H * W)
    tr = NeRFTrainer(model, cfg, lr=1e-2, n_rays=512, image_hw=(H, W),
                     device=device)
    return model, cfg, tr


def main(argv=None):
    """Returns {"psnr", "acc", "seconds", "losses"}; losses maps each loss
    part to its value at every step, in step order."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    H, W = args.hw
    frames, intr = make_synthetic_scene(6, H, W)
    _, _, tr = build((H, W), device)
    tr.init()
    as_t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    batches = [{"pose": as_t(fr["pose"]), "intrinsics": as_t(intr),
                "image": as_t(fr["image"]), "label": as_t(fr["label"]),
                "depth": as_t(fr["depth"]),
                "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
               for fr in frames]
    generator = torch.Generator(device=device).manual_seed(1)
    history = []
    t0 = time.time()
    for step in range(args.steps):
        parts = tr.train_step(batches[step % len(batches)], generator, None)
        history.append(parts)
        if step % 30 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  rgb {float(parts['loss_nerf_rgb']):.4f}  "
                  f"sem {float(parts['loss_nerf_semantics']):.4f}  "
                  f"depth {float(parts['loss_depth']):.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.time() - t0
    print(f"trained {args.steps} steps in {seconds:.1f}s")

    fr = frames[0]
    rays = get_rays(fr["pose"], intr, H, W, device=device)
    out = tr.render_image(None, fr["pose"], intr, rays)
    pred = out["nerf_rgb"].cpu().numpy()
    mse = ((pred - fr["image"]) ** 2).mean()
    acc = (out["nerf_semantics"].cpu().numpy() == fr["label"]).mean()
    psnr = float(-10 * np.log10(mse))
    print(f"PSNR {psnr:.2f} dB  semantic acc {acc:.3f}")
    losses = {k: [float(p[k]) for p in history] for k in parts}
    return {"psnr": psnr, "acc": float(acc), "seconds": seconds,
            "losses": losses}


if __name__ == "__main__":
    main()
