"""Row gather out[i] = table[idx[i]] on the card: the port's counterpart of
scripts/bench_dma_gather.py, whose `make_dma_gather` is the repository's one
Pallas kernel (a TPU prototype that nothing else calls).

`dma_gather` wraps the CUDA kernel csrc/dma_gather.cu; `dma_gather_plain`
(torch.index_select) is the same function, taken for CPU tensors.
`measure()` checks the kernel against it and times both, and `table[idx]`,
at each row width of the script's main() — a 2^19-row table, 8,388,608
sorted int32 indices, bf16 rows of F = 2, 8 and 128 and f32 rows of
F = 16 — and `main()` prints ns per row:

    python -m ucsa_neural_rendering_tpu_torch.bench.dma_gather [--m M] [--t T]

`measure_sector_rate()` (`--l2-probe`) is the card's own rate of scattered
L2 reads: the same kernel on PROBE_M random, unsorted indices into tables
of about 8, 25 and 55 MB (inside the 50 MB L2, about half of it, past it)
of 8-, 16- and 32-byte rows, each row one 32-byte sector, reported as
sectors read per second. A warp's load touches 16 (8- and 32-byte rows:
two threads a row) or 32 (16-byte rows) rows, each in its own sector.
The gather also reads its indices and writes its rows (both contiguous),
so the rate of all the sectors it moves is reported beside; the card's
rate (`l2_sector_rate`) is the fastest of those inside L2.

It measures the card and raises without one.
"""

import argparse
import json
import statistics
import subprocess

import torch

from .. import kernels
from ..utils.device import resolve_device
from . import device_ms

# scripts/bench_dma_gather.py main(): DMA_M indices into a DMA_T-row table
M_ROWS, T_ROWS = 8_388_608, 1 << 19
# the (F, dtype) of each row width of the script's main()
ROW_WIDTHS = ((2, torch.bfloat16), (8, torch.bfloat16), (16, torch.float32),
              (128, torch.bfloat16))
SEED = 0
# the L2 probe: row widths, table sizes and random indices a gather
PROBE_ROW_BYTES = (8, 16, 32)
PROBE_TABLE_MB = (8, 25, 55)
PROBE_M = 1 << 21
SECTOR_BYTES = 32


def dma_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the dma_gather kernel: table[idx] by
    torch.index_select."""
    return torch.index_select(table, 0, idx)


def dma_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, F] (any dtype) whose rows are a power of two of at least
    4 bytes, idx [M] int32 in [0, T) → [M, F] rows of the table. CUDA
    tensors launch dma_gather (the indices are not checked there); CPU
    tensors take the plain version."""
    if not table.is_cuda:
        return dma_gather_plain(table, idx)
    if table.ndim != 2:
        raise ValueError(f"table: expected [T, F], got {tuple(table.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes < 4 or row_bytes & (row_bytes - 1):
        raise ValueError(f"dma_gather copies rows of 4, 8, 16, ... bytes, "
                         f"not {row_bytes}")
    kernels.check(table, "table", table.dtype)
    m = idx.shape[0]
    kernels.check(idx, "idx", torch.int32, (m,), table.device)
    out = torch.empty((m, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel():
        kernels.launch("dma_gather", table, idx, out, m, row_bytes)
    return out


def gather_inputs(t: int, m: int, f: int, dtype, device):
    """A [t, f] table of normal values and m sorted uniform int32 indices,
    made on the device from SEED."""
    g = torch.Generator(device).manual_seed(SEED)
    table = torch.randn((t, f), generator=g, device=device).to(dtype)
    idx = torch.randint(0, t, (m,), generator=g, device=device,
                        dtype=torch.int32)
    return table, torch.sort(idx).values


def measure(m: int = M_ROWS, t: int = T_ROWS, device="cuda") -> list[dict]:
    """Per row width: whether the kernel's rows equal index_select's, and
    the device ms (profiler, warm L2) and ns per row of the kernel, of
    index_select and of table[idx] (aten::index)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the gather benchmark measures the card: it needs "
                           "a CUDA device")
    rows = []
    for f, dtype in ROW_WIDTHS:
        table, idx = gather_inputs(t, m, f, dtype, dev)
        equal = torch.equal(dma_gather(table, idx),
                            dma_gather_plain(table, idx))
        ms = device_ms(lambda: dma_gather(table, idx))
        select_ms = device_ms(lambda: dma_gather_plain(table, idx))
        index_ms = device_ms(lambda: table[idx])
        rows.append(dict(
            f=f, dtype=str(dtype).removeprefix("torch."),
            row_bytes=f * table.element_size(), m=m, t=t,
            distinct_rows=torch.unique_consecutive(idx).numel(),
            equal=equal, ms=ms, index_select_ms=select_ms, index_ms=index_ms,
            ns_per_row=ms * 1e6 / m,
            index_select_ns_per_row=select_ms * 1e6 / m,
            index_ns_per_row=index_ms * 1e6 / m))
        del table, idx
    return rows


def probe_work(table_mb: int, row_bytes: int, m: int) -> dict:
    """The shape of one probe gather: the table's rows, and the 32-byte
    sectors it reads (one a row: a row of at most 32 bytes lies in one
    aligned sector), reads of its int32 indices (contiguous) and writes
    (the rows out, contiguous)."""
    if row_bytes > SECTOR_BYTES or SECTOR_BYTES % row_bytes:
        raise ValueError(f"probe rows divide a sector, not {row_bytes} B")
    return dict(table_mb=table_mb, row_bytes=row_bytes, m=m,
                t=table_mb * 10 ** 6 // row_bytes, sectors_read=m,
                sectors_index=-(-m * 4 // SECTOR_BYTES),
                sectors_written=m * row_bytes // SECTOR_BYTES)


def measure_sector_rate(m: int = PROBE_M, repeats: int = 3,
                        device="cuda") -> list[dict]:
    """The L2 probe: per (table size, row width), dma_gather of m random
    unsorted rows, `repeats` times by bench.device_ms (warm: the table's
    first pass is the warm-up); at the median device time, the rows'
    sectors read a second and all the sectors the gather moves (rows,
    indices, output) a second."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the L2 probe measures the card: it needs a CUDA "
                           "device")
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for table_mb in PROBE_TABLE_MB:
        for row_bytes in PROBE_ROW_BYTES:
            w = probe_work(table_mb, row_bytes, m)
            table = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                  (w["t"], row_bytes // 4), generator=g,
                                  device=dev, dtype=torch.int32)
            idx = torch.randint(0, w["t"], (m,), generator=g, device=dev,
                                dtype=torch.int32)
            if not torch.equal(dma_gather(table, idx),
                               dma_gather_plain(table, idx)):
                raise AssertionError(f"dma_gather disagrees with "
                                     f"index_select at {w}")
            ms = [device_ms(lambda: dma_gather(table, idx))
                  for _ in range(repeats)]
            med = statistics.median(ms)
            rows.append(dict(
                w, ms=ms, median_ms=med,
                sectors_read_per_s=m / (med * 1e-3),
                sectors_per_s=(m + w["sectors_index"] + w["sectors_written"])
                / (med * 1e-3)))
            del table, idx
    return rows


def l2_sector_rate(rows: list[dict]) -> float:
    """The card's L2 sector rate from the probe's rows: the fastest rate,
    with a table inside L2, of all the sectors a gather moves (its rows',
    its indices' and its output's), a second."""
    return max(r["sectors_per_s"] for r in rows
               if r["table_mb"] < PROBE_TABLE_MB[-1])


def probe_lines(rows: list[dict]) -> list[str]:
    return [f"L2 probe, {r['table_mb']} MB table of {r['row_bytes']}-byte "
            f"rows, {r['m']} random rows: median {r['median_ms']:.5f} ms "
            f"(of {', '.join(f'{t:.5f}' for t in r['ms'])}), "
            f"{r['sectors_read_per_s'] / 1e9:.1f} G sectors read/s "
            f"({r['sectors_read_per_s'] * SECTOR_BYTES / 1e12:.3f} TB/s), "
            f"{r['sectors_per_s'] / 1e9:.1f} G with the indices' and the "
            f"output's" for r in rows]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=M_ROWS, help="indices")
    ap.add_argument("--t", type=int, default=T_ROWS, help="table rows")
    ap.add_argument("--l2-probe", action="store_true",
                    help="measure the card's L2 sector rate instead")
    args = ap.parse_args(argv)
    if args.l2_probe:
        rows = measure_sector_rate()
        print(card_line())
        print("\n".join(probe_lines(rows)))
        print(json.dumps({"l2_probe": rows,
                          "l2_sector_rate": l2_sector_rate(rows)}))
        return rows
    rows = measure(args.m, args.t)
    print(f"{torch.cuda.get_device_name(0)}: M={args.m} rows, table "
          f"{args.t} rows")
    for r in rows:
        print(f"row {r['row_bytes']:4d}B ({r['dtype']} F={r['f']}): "
              f"dma_gather {r['ns_per_row']:.4f} ns/row  index_select "
              f"{r['index_select_ns_per_row']:.4f}  table[idx] "
              f"{r['index_ns_per_row']:.4f} ns/row"
              f"{'' if r['equal'] else '  !WRONG'}", flush=True)
    print(json.dumps({"dma_gather": rows}))
    if not all(r["equal"] for r in rows):
        raise SystemExit("dma_gather disagrees with index_select")
    return rows


if __name__ == "__main__":
    main()
