"""K8's two kernels, pack_table and hash_encode_packed_fwd, checked and
timed on the card at the main path's shapes, judged against the card's own
L2 sector rate:

  encode  hash_encode_packed_fwd through the render's fp8 rows (2^23
          budget) at the test frame's 65,536 and predict's 32,768 points
          (exact mode), and through a step's bf16 rows (2^21) at its
          98,304 and 32,768 points in all three modes (exact, probe, face);
  pack    pack_table at the shipped 8 × 4 geometry at both budgets and
          row types, and at the reference's 16 × 2 render's (fp8, 2^23)
          and step's (bf16, 2^21) budgets;
  floors  each kernel at its smallest shape (32 points; one packed level
          of 8 cells): the launch floor.

Tables are U(-1, 1) from --seed; points lie along rays (4096 rays, the
call's samples a ray, sorted along a segment, as a path's samples lie).
Each kernel is first held bit-equal to its plain version (fp8 NaN rows by
their bits). The L2 probe (bench.dma_gather.measure_sector_rate) runs
first, and its rate sets the sector floors. Times are bench.device_ms
(profiler device time), a median and its spread over --turns. With
--first-version DIR (a directory of the two kernels' earlier sources, e.g.
the parent commit's `csrc` from git archive), every shape also times that
version, in turns (first, this, this, first, ...), held bit-equal too:

    python -m ucsa_neural_rendering_tpu_torch.bench.packed_kernels \\
        [--first-version DIR] [--turns N] [--seed S] [--out FILE]

It prints the card's name and power limit, a line a shape and, last, one
JSON object. It measures the card and raises without one.
"""

import argparse
import contextlib
import json
import statistics

import torch

from .. import kernels
from ..models import hash_encoding as he
from ..models import packed_table as pt
from ..utils.device import resolve_device
from . import PROFILES, device_ms
from . import dma_gather as dg
from .dma_gather import SECTOR_BYTES
from .face_encode import BOUND, HBM_BYTES_PER_S, LOG2, N_RAYS, ray_points

KERNELS = ("pack_table", "hash_encode_packed_fwd")
RENDER_PACK, TRAIN_PACK = (2 ** 23, "fp8"), (2 ** 21, "bf16")
# (label, levels, features, (budget, row type), mode, samples a ray)
ENCODE_SHAPES = (
    ("test stage 1", 8, 4, RENDER_PACK, "exact", 16),
    ("predict stage 1", 8, 4, RENDER_PACK, "exact", 8),
    *((f"step coarse {m}", 8, 4, TRAIN_PACK, m, 24)
      for m in ("exact", "probe", "face")),
    *((f"step new {m}", 8, 4, TRAIN_PACK, m, 8)
      for m in ("exact", "probe", "face")),
)
# (label, levels, features, (budget, row type))
PACK_SHAPES = (
    ("8 x 4 render fp8", 8, 4, RENDER_PACK),
    ("8 x 4 render bf16", 8, 4, (RENDER_PACK[0], "bf16")),
    ("8 x 4 step fp8", 8, 4, (TRAIN_PACK[0], "fp8")),
    ("8 x 4 step bf16", 8, 4, TRAIN_PACK),
    ("16 x 2 render fp8", 16, 2, RENDER_PACK),
    ("16 x 2 step bf16", 16, 2, TRAIN_PACK),
)


def spec_of(levels: int, features: int) -> he.HashGridSpec:
    return he.make_spec(levels, features, LOG2, 16,
                        he.ngp_per_level_scale(BOUND, levels))


def _distinct_sectors(byte_offsets: torch.Tensor, warp: int = 32) -> int:
    """The distinct 32-byte sectors of [N, k] byte offsets, counted within
    each warp of `warp` consecutive rows (a warp's loads at one level:
    what one pass of its points over the level must take from L2, however
    its loads split them) and summed."""
    if byte_offsets.numel() == 0:
        return 0
    n = byte_offsets.shape[0]
    group = torch.arange(n, device=byte_offsets.device) // warp
    sec = byte_offsets // SECTOR_BYTES
    key = (group[:, None] << 40) + sec
    return int(torch.unique(key).numel())


def encode_work(x01: torch.Tensor, spec: he.HashGridSpec, n_packed: int,
                row_bytes: int, mode: str) -> dict:
    """The bytes and 32-byte sectors of hash_encode_packed_fwd on x01 [N, 3]
    through packed rows of row_bytes on the levels [0, n_packed), mode's
    lookup of the bf16 table on the rest. bytes: points in, features out,
    each distinct packed row and table row read once. sectors: for each
    warp of 32 consecutive points and each level, the distinct sectors of
    the rows its points read (a packed row: row_bytes / 32 sectors, at
    least 1; x-neighbours in one sector, and points of a warp on one row,
    count once)."""
    n, L, F, k = x01.shape[0], spec.n_levels, spec.n_features, n_packed
    cells = pt.packed_cell_rows(x01, spec, k)
    if mode == "exact":
        rows = [he._level_indices(x01, spec.resolutions[lv], spec.sizes[lv],
                                  spec.hashed[lv])[0] + spec.offsets[lv]
                for lv in range(k, L)]
    elif mode == "probe":
        idx = he.sampled_corner_indices(x01, spec, range(k, L))
        rows = [idx[:, i:i + 1] for i in range(L - k)]
    elif mode == "face":
        face = he.sampled_face_rows(x01, spec)[0]  # [N, L, 4]
        rows = [face[:, lv] for lv in range(k, L)]
    else:
        raise ValueError(f"mode: {mode!r}")
    table_rows = torch.cat(rows, 1) if rows else cells[:, :0]
    n_bytes = (n * 12 + n * L * F * 2
               + torch.unique(cells).numel() * row_bytes
               + torch.unique(table_rows).numel() * F * 2)
    per_row = max(1, row_bytes // SECTOR_BYTES)
    sectors = sum(
        _distinct_sectors((cells[:, lv:lv + 1] * per_row)
                          * SECTOR_BYTES) * per_row
        for lv in range(k)) + sum(_distinct_sectors(r * (F * 2))
                                  for r in rows)
    return dict(points=n, n_packed=k, bytes=n_bytes, sectors=sectors,
                sectors_a_point=sectors / n)


def pack_work(table: torch.Tensor, spec: he.HashGridSpec, n_packed: int,
              row_bytes: int) -> dict:
    """The bytes and 32-byte sectors of pack_table: the rows written
    (whole sectors) and each distinct vertex row of F f32 read once (the
    distinct sectors those rows lie in)."""
    F = spec.n_features
    written = pt.packed_offsets(spec, n_packed)[1] * row_bytes
    vertex_rows = []
    for lvl in range(n_packed):
        res, s = spec.resolutions[lvl], spec.resolutions[lvl] + 1
        if spec.hashed[lvl]:
            ax = torch.arange(s, device=table.device)
            idx = he._hash_index(ax[None, None, :], ax[None, :, None],
                                 ax[:, None, None], res, spec.sizes[lvl],
                                 True).reshape(-1)
        else:
            idx = torch.arange(s ** 3, device=table.device)
        vertex_rows.append(torch.unique(idx + spec.offsets[lvl]))
    rows = torch.cat(vertex_rows)
    read_sectors = torch.unique(rows * (F * 4) // SECTOR_BYTES).numel()
    return dict(rows=written // row_bytes, bytes=written + rows.numel() * F * 4,
                sectors=-(-written // SECTOR_BYTES) + read_sectors,
                mb_written=written / 1e6, mb_vertices=rows.numel() * F * 4 / 1e6)


def _bits(d: torch.Tensor) -> torch.Tensor:
    return d.view(torch.uint8) if d.element_size() == 1 else d.view(torch.int16)


def fp8_edges(table: torch.Tensor) -> torch.Tensor:
    """A copy of an f32 table with fp8's edge values planted in its first
    level: ±inf, 464 (rounds to 448), 464 + 1 ulp and -500 (NaN), 448 and
    subnormals."""
    edge = torch.tensor([float("inf"), float("-inf"), 464.0, 464.00003,
                         -500.0, 448.0, 2.0 ** -10, 1.5 * 2.0 ** -9],
                        device=table.device)
    table = table.clone()
    table.view(-1)[:8 * 97:97] = edge
    return table


def _summary(ms: list) -> dict:
    return dict(ms=ms, median_ms=statistics.median(ms), min_ms=min(ms),
                max_ms=max(ms))


def _side(side, first_dir):
    """The kernels of `side`: this tree's, or ("first") first_dir's."""
    return kernels.sources_from(first_dir, KERNELS) if side == "first" \
        else contextlib.nullcontext()


def _time(fn, sides, first_dir, turns: int) -> dict:
    """fn timed `turns` times on each side, in turns (first, this, this,
    first, ...). Returns {side: summary}."""
    ms = {s: [] for s in sides}
    for t in range(turns):
        for s in (sides if t % 2 == 0 else sides[::-1]):
            with _side(s, first_dir):
                ms[s].append(device_ms(fn))
    return {s: _summary(v) for s, v in ms.items()}


def _check(fn, plain, sides, first_dir, what):
    """fn's result on each side equal (by bits) to plain's."""
    ref = plain()
    outs = {}
    for s in sides:
        with _side(s, first_dir):
            outs[s] = fn()
    torch.cuda.synchronize()
    for side, out in outs.items():
        if not torch.equal(_bits(out), _bits(ref)):
            raise AssertionError(f"{what}: the {side} version differs from "
                                 f"the plain one")


def measure(device="cuda", turns: int = 4, seed: int = 0, first_dir=None,
            log=print) -> dict:
    """The L2 probe, then every shape checked and timed (with first_dir,
    the first version too, in turns); a line a shape to `log`. Returns the
    card, the probe's rows and rate and a row a shape."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the packed kernels' bench times the card's "
                           "kernels")
    probe = dg.measure_sector_rate()
    for line in dg.probe_lines(probe):
        log(line)
    rate = dg.l2_sector_rate(probe)
    log(f"the card's L2 sector rate (the probe's fastest inside L2): "
        f"{rate / 1e9:.1f} G sectors/s, {rate * SECTOR_BYTES / 1e12:.3f} TB/s")
    sides = ("this",) if first_dir is None else ("first", "this")
    g = torch.Generator().manual_seed(seed)
    tables, rows = {}, []

    def table_of(levels, features):
        if (levels, features) not in tables:
            spec = spec_of(levels, features)
            t = (torch.rand((spec.table_size, features), generator=g) * 2
                 - 1).to(device)
            tables[(levels, features)] = (spec, t)
        return tables[(levels, features)]

    def shape_row(kind, label, work, fn, plain):
        _check(fn, plain, sides, first_dir, f"{kind} {label}")
        t = _time(fn, sides, first_dir, turns)
        row = dict(kind=kind, where=label, **work,
                   bytes_bound_ms=1e3 * work["bytes"] / HBM_BYTES_PER_S,
                   sector_floor_ms=1e3 * work["sectors"] / rate, **t)
        if first_dir is not None:
            row["this_over_first"] = (t["this"]["median_ms"]
                                      / t["first"]["median_ms"])
        rows.append(row)
        log(f"{kind} {label}: " + "; ".join(
            f"{s} median {t[s]['median_ms']:.5f} ms ({t[s]['min_ms']:.5f}–"
            f"{t[s]['max_ms']:.5f})" for s in sides)
            + f"; bytes bound {row['bytes_bound_ms']:.5f} ms, "
            f"{work['sectors']} sectors, floor {row['sector_floor_ms']:.5f} ms"
            + (f"; this / first {row['this_over_first']:.3f}"
               if first_dir is not None else ""))

    for label, levels, features, (budget, dtype) in PACK_SHAPES:
        spec, table = table_of(levels, features)
        table = fp8_edges(table)
        k = pt.choose_n_packed(spec, budget)
        row_bytes = 8 * features * (1 if dtype == "fp8" else 2)
        shape_row("pack_table", label,
                  dict(budget=budget, row_dtype=dtype, n_packed=k,
                       **pack_work(table, spec, k, row_bytes)),
                  lambda: pt.build_packed_table(table, spec, k, dtype).data,
                  lambda: pt.build_packed_table_plain(table, spec, k,
                                                      dtype).data)

    for label, levels, features, (budget, dtype), mode, samples \
            in ENCODE_SHAPES:
        spec, table = table_of(levels, features)
        tb = table.to(torch.bfloat16)
        packed = pt.build_packed_table(table, spec,
                                       pt.choose_n_packed(spec, budget),
                                       dtype)
        x01 = ray_points(N_RAYS, samples, g).to(device)
        row_bytes = packed.data.shape[1] * packed.data.element_size()
        shape_row("hash_encode_packed_fwd", label,
                  dict(mode=mode, row_dtype=dtype,
                       **encode_work(x01, spec, packed.n_packed, row_bytes,
                                     mode)),
                  lambda: pt.hash_encode_packed(tb, packed, x01, spec, mode),
                  lambda: pt.hash_encode_packed_plain(tb, packed, x01, spec,
                                                      mode))

    # launch floors: the smallest shapes
    spec, table = table_of(8, 4)
    tb = table.to(torch.bfloat16)
    packed = pt.build_packed_table(table, spec, 3, "fp8")
    x01 = torch.rand((32, 3), generator=g).to(device)
    shape_row("hash_encode_packed_fwd", "launch floor, 32 points",
              dict(mode="exact", row_dtype="fp8",
                   **encode_work(x01, spec, 3, 32, "exact")),
              lambda: pt.hash_encode_packed(tb, packed, x01, spec),
              lambda: pt.hash_encode_packed_plain(tb, packed, x01, spec))
    tiny = he.make_spec(1, 4, 12, 2, 1.5)
    tiny_table = (torch.rand((tiny.table_size, 4), generator=g) * 2
                  - 1).to(device)
    shape_row("pack_table", "launch floor, 8 cells",
              dict(budget=8, row_dtype="fp8", n_packed=1,
                   **pack_work(tiny_table, tiny, 1, 32)),
              lambda: pt.build_packed_table(tiny_table, tiny, 1, "fp8").data,
              lambda: pt.build_packed_table_plain(tiny_table, tiny, 1,
                                                  "fp8").data)
    return dict(device=torch.cuda.get_device_name(device),
                card=dg.card_line(), turns=turns,
                first_version=None if first_dir is None else str(first_dir),
                l2_sector_rate=rate, l2_probe=probe, shapes=rows,
                profiles=dict(PROFILES))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--first-version", default=None,
                   help="a directory of the two kernels' earlier sources")
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    print(dg.card_line(), flush=True)
    res = measure("cuda", args.turns, args.seed, args.first_version,
                  log=lambda s: print(s, flush=True))
    print(f"bench.device_ms: {res['profiles']['taken']} profiles, "
          f"{res['profiles']['short']} of them short and taken again, "
          f"{res['profiles']['recounted']} counted by launches", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
