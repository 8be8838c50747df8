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

It measures the card and raises without one.
"""

import argparse
import json

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


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=M_ROWS, help="indices")
    ap.add_argument("--t", type=int, default=T_ROWS, help="table rows")
    args = ap.parse_args(argv)
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
