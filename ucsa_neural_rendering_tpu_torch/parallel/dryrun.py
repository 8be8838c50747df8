"""Data-parallel dry run over n ranks (the port's twin of the repository's
`__graft_entry__.dryrun_multichip`, which jits the same two steps over n
virtual devices):

  1. SegTrainer.train_step: the pretrain semantics, the batch sharded over
     the ranks, synced BatchNorm, gradients summed, the confusion matrix
     summed; the tiny backbone layout;
  2. JointTrainer.joint_step: per-image NeRF updates with the rays sharded,
     the staged full-frame renders sharded by chunk, the augmentation, and
     one seg step on the assembled (rendered ⊕ replay) batch.

`run_ranks(target, n, workdir, ...)` spawns n processes, one rank each,
joined by a `file://` store under workdir (no port, so parallel callers
never collide), calls target(mesh, *args) on each and returns the ranks'
results in rank order; it raises when a rank fails or outlives its
timeout. The tests use it for their own workloads.

  python -m ucsa_neural_rendering_tpu_torch.parallel.dryrun --ranks 2
"""

import argparse
import multiprocessing as mp
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import get_mesh, shutdown


def _rank_main(target, rank, world, workdir, device, backend, args):
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            os.environ.setdefault("LOCAL_RANK", str(rank))
        dist.init_process_group(
            backend, init_method=f"file://{workdir}/store", rank=rank,
            world_size=world)
        mesh = get_mesh(device)
        result = target(mesh, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
        shutdown()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(target, world: int, workdir: str, *args, device="cpu",
              backend="gloo", timeout: float = 300.0) -> list:
    """target(mesh, *args) on `world` spawned ranks (module docstring).
    target must be importable by name (a module-level function)."""
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, workdir, device, backend,
                               args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0 and r not in late:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if late:
        errors.append(f"ranks {late} still running after {timeout} s")
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _dryrun_rank(mesh):
    from ..models import TINY_LAYOUT, DeepLabV3, SemanticNeRF
    from ..ops.renderer import RenderConfig
    from ..train import JointTrainer, SegTrainer

    n = mesh.size
    dev = mesh.device
    H = W = 16
    rng = np.random.default_rng(0)

    seg = SegTrainer(DeepLabV3(num_classes=8, backbone_layout=TINY_LAYOUT,
                               aspp_channels=16, head_channels=16,
                               device=dev,
                               generator=torch.Generator().manual_seed(2)),
                     {"name": "Adam", "lr": 1e-4}, mesh=mesh)
    images = torch.from_numpy(rng.uniform(0, 1, (2 * n, H, W, 3))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, 8, (2 * n, H, W)))
    seg_loss, conf = seg.train_step(images, labels, 1e-4,
                                    torch.Generator(dev).manual_seed(1))

    exp = {"optimizer": {"lr_nerf": 1e-2, "lr_seg": 1e-4, "name": "Adam"},
           "nerf": {"use_occupancy": False}}
    jt = JointTrainer(
        exp, image_hw=(H, W), num_classes=8,
        render_cfg=RenderConfig(num_steps=8, upsample_steps=8,
                                max_ray_batch=H * W),
        n_rays=16 * n,
        nerf_model=SemanticNeRF(bound=1.0, num_semantic_classes=8,
                                n_levels=4, log2_hashmap_size=10, device=dev,
                                generator=torch.Generator().manual_seed(3)),
        seg_model=DeepLabV3(num_classes=8, backbone_layout=TINY_LAYOUT,
                            aspp_channels=16, head_channels=16, device=dev,
                            generator=torch.Generator().manual_seed(4)),
        mesh=mesh)
    jt.init()
    # rendered new frames (b) and replay frames (old_n ≥ 1), so that the
    # assembled seg batch of b + old_n need not divide the ranks
    b = max(2, n // 4)
    old_n = max(1, n - b)
    batch_new = {
        "img": rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32),
        "depth": np.full((b, H, W), 0.8, np.float32),
        "pose": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "intrinsics": np.tile(np.array([12.0, 12.0, W / 2, H / 2],
                                       np.float32), (b, 1)),
        "one_m_to_scene_uom": np.ones(b, np.float32),
    }
    batch_old = {
        "img": rng.uniform(0, 1, (old_n, H, W, 3)).astype(np.float32),
        "nerf_label": rng.integers(-1, 8, (old_n, H, W)).astype(np.int32),
    }
    logs = jt.joint_step(batch_old, batch_new, None,
                         torch.Generator(dev).manual_seed(5))
    return {"seg_loss": float(seg_loss), "conf": conf.cpu(),
            "joint_logs": {k: float(v) for k, v in logs.items()},
            "seg": {k: v.cpu() for k, v in seg.model.state_dict().items()},
            "joint_nerf": {k: v.cpu() for k, v in
                           jt.nerf.model.state_dict().items()},
            "joint_seg": {k: v.cpu() for k, v in
                          jt.seg.model.state_dict().items()}}


def dryrun_multichip(n_ranks: int, workdir: str | None = None,
                     device="cpu", backend="gloo",
                     timeout: float = 300.0) -> list:
    """Run both steps on n_ranks spawned ranks; check finite losses and
    that every rank holds the same parameters bit for bit afterwards.
    Returns the ranks' results."""
    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(_dryrun_rank, n_ranks, workdir or tmp,
                            device=device, backend=backend, timeout=timeout)
    for r in results:
        assert np.isfinite(r["seg_loss"]), r["seg_loss"]
        assert all(np.isfinite(v) for v in r["joint_logs"].values()), \
            r["joint_logs"]
    for r in results[1:]:
        for part in ("seg", "joint_nerf", "joint_seg"):
            for k, v in r[part].items():
                assert torch.equal(v, results[0][part][k]), (part, k)
        assert torch.equal(r["conf"], results[0]["conf"])
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--backend", default="gloo")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    results = dryrun_multichip(args.ranks, device=args.device,
                               backend=args.backend)
    print(f"dryrun over {args.ranks} ranks ({args.backend}, {args.device}): "
          f"seg loss {results[0]['seg_loss']:.6f}, joint "
          f"{results[0]['joint_logs']}, ranks bit-equal, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
