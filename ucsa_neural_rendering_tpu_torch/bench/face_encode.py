"""The face forward encode (K9, stochastic_fwd="face") timed two ways on the
card, in turns:

  unpacked  hash_encode_face_fwd: each (point, level) blends its sampled
            face's 4 bf16 rows of the table;
  packed    hash_encode_packed_fwd's face mode through a training step's
            packed table (bf16 rows of the levels within
            train_packed_max_entries = 2^21, one row a (point, level)
            there): the face hybrid a "face" step runs on the card.

At the "face" training step's two density calls (98,304 and 32,768 points:
4096 rays of 24 + 8 samples, each ray's samples sorted along a segment of
half the scene's width from a seeded origin and direction, as a step's
samples lie along its rays) on the shipped 8 × 4 and the reference's
16 × 2 geometry (2^19 rows, bound 4), each kernel first held bit-equal to
its plain version, then timed by bench.device_ms (profiler device time) in
turns (unpacked, packed, packed, unpacked, ...):

    python -m ucsa_neural_rendering_tpu_torch.bench.face_encode [--turns N]

It prints a line a shape and, last, one JSON object. `bytes_bound_ms`:
points in, features out and each distinct row (of the table, or of the
packed table) read once, at 3.35 TB/s; `sector_mb`: one 32-byte L2 sector
for each row read (a packed bf16 row of 8 × 4 features: 2). It measures the
card and raises without one.
"""

import argparse
import json
import statistics

import torch

from ..models import hash_encoding as he
from ..models import packed_table as pt
from ..utils.device import resolve_device
from . import device_ms

GEOMETRIES = ((8, 4), (16, 2))  # (levels, features): shipped, reference
N_RAYS = 4096
SAMPLES = (24, 8)  # the "face" step's coarse and fine calls' samples a ray
LOG2, BOUND = 19, 4.0
TRAIN_BUDGET = 2 ** 21  # RenderConfig.train_packed_max_entries
HBM_BYTES_PER_S = 3.35e12


def _work(x01, spec, packed):
    """(bytes the function must move, bytes of the 32-byte sectors its row
    reads touch) of the face encode of x01, unpacked (packed None) or
    through packed."""
    n, L, F = x01.shape[0], spec.n_levels, spec.n_features
    k = 0 if packed is None else packed.n_packed
    idx = he.sampled_face_rows(x01, spec)[0][:, k:]
    n_bytes = n * 12 + n * L * F * 2 + torch.unique(idx).numel() * F * 2
    sectors = n * (L - k) * 4
    if k:
        row_bytes = packed.data.shape[1] * packed.data.element_size()
        n_bytes += torch.unique(pt.packed_cell_rows(x01, spec, k)
                                ).numel() * row_bytes
        sectors += n * k * -(-row_bytes // 32)
    return n_bytes, 32 * sectors


def ray_points(n_rays, samples, g):
    """[n_rays·samples, 3] x01 points along rays: origins in the middle of
    the cube, unit directions, samples sorted uniform over half the cube's
    width, clipped to [0, 1]."""
    o = torch.rand((n_rays, 1, 3), generator=g) * 0.5 + 0.25
    d = torch.randn((n_rays, 1, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.sort(torch.rand((n_rays, samples, 1), generator=g) * 0.5,
                   dim=1).values
    return (o + d * t).clamp(0, 1).reshape(-1, 3)


def measure(device="cuda", turns: int = 2, seed: int = 0) -> dict:
    """Check and time both encodes at every (geometry, points); returns
    {"shapes": [one dict a shape]}."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the face bench times the card's kernels")
    g = torch.Generator().manual_seed(seed)
    shapes = []
    for levels, features in GEOMETRIES:
        spec = he.make_spec(levels, features, LOG2, 16,
                            he.ngp_per_level_scale(BOUND, levels))
        table = (torch.rand((spec.table_size, features), generator=g) * 2
                 - 1).to(device)
        tb = table.to(torch.bfloat16)
        packed = pt.build_packed_table(
            table, spec, pt.choose_n_packed(spec, TRAIN_BUDGET), "bf16")
        for samples in SAMPLES:
            x01 = ray_points(N_RAYS, samples, g).to(device)
            n = x01.shape[0]
            sides = {
                "unpacked": (lambda: he.hash_encode_face(tb, x01, spec),
                             lambda: he.hash_encode_face_plain(tb, x01,
                                                               spec), None),
                "packed": (lambda: pt.hash_encode_packed(tb, packed, x01,
                                                         spec, "face"),
                           lambda: pt.hash_encode_packed_plain(
                               tb, packed, x01, spec, "face"), packed)}
            row = dict(levels=levels, features=features, points=n,
                       n_packed=packed.n_packed)
            for name, (fn, plain, pk) in sides.items():
                out = fn()
                torch.cuda.synchronize()
                assert torch.equal(out, plain()), (name, levels, n)
                n_bytes, sector_bytes = _work(x01, spec, pk)
                row[name] = dict(ms=[], bytes_bound_ms=1e3 * n_bytes
                                 / HBM_BYTES_PER_S,
                                 sector_mb=sector_bytes / 1e6)
            for t in range(turns):
                order = ("unpacked", "packed") if t % 2 == 0 else \
                    ("packed", "unpacked")
                for name in order:
                    row[name]["ms"].append(device_ms(sides[name][0]))
            for name in sides:
                row[name]["mean_ms"] = statistics.mean(row[name]["ms"])
            row["packed_over_unpacked"] = (row["packed"]["mean_ms"]
                                           / row["unpacked"]["mean_ms"])
            shapes.append(row)
    return {"device": torch.cuda.get_device_name(device), "turns": turns,
            "shapes": shapes}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    res = measure("cuda", args.turns, args.seed)
    for r in res["shapes"]:
        u, k = r["unpacked"], r["packed"]
        print(f"{r['levels']} x {r['features']}, {r['points']} points "
              f"({r['n_packed']} levels packed): unpacked "
              f"{u['mean_ms']:.5f} ms (bytes bound {u['bytes_bound_ms']:.5f},"
              f" {u['sector_mb']:.2f} MB of sectors), packed "
              f"{k['mean_ms']:.5f} ms (bytes bound {k['bytes_bound_ms']:.5f},"
              f" {k['sector_mb']:.2f} MB of sectors): packed / unpacked "
              f"{r['packed_over_unpacked']:.3f}", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
