"""Cell-packed hash-grid tables (counterpart of
ucsa_neural_rendering_tpu/models/packed_table.py, K8).

A packed level holds, for each of its res³ cells, one row of the 8 corner
vertices' features ([8·F], corner-major: corner c moves axis a by
(c >> a) & 1), read as they are stored in the table: a dense level's
vertex grid sliced, a hashed level's vertices hashed at pack time. An
encode then reads one row per (point, packed level) where it read 8. The
levels whose cell count fits a budget are packed (a prefix: resolutions
grow). Rows are stored as bf16 (the exact relayout, the training steps'
default) or fp8 e4m3 (the renders' default), each value rounded once from
the f32 table.

Two CUDA kernels, each with its wrapper and plain PyTorch version here
(on a CUDA tensor the wrapper launches the kernel, on a CPU tensor it takes
`<name>_plain`):
  build_packed_table  csrc/pack_table.cu             the relayout
                                                     (`build_packed_table`)
  hash_encode_packed  csrc/hash_encode_packed_fwd.cu the encode through a
                                                     packed table in three
                                                     modes (`hash_encode_packed`,
                                                     `hash_encode_packed_probe`,
                                                     `hash_encode_packed_face`)
`PackedTableCache` packs once per version of the table for the renders.
The trainers pack where `ops.renderer.packing_enabled` says, which stands
the card where the JAX package's TPU stands.
"""

from dataclasses import dataclass

import torch

from .. import kernels
from .hash_encoding import (_CORNERS, HashGridSpec, _blend,
                            _check_kernel_args, _corner_uniform,
                            _corner_weights, _hash_index, _KERNEL_FEATURES,
                            _KERNEL_MAX_LEVELS, _level_face_rows,
                            _level_indices, _level_meta,
                            sampled_corner_indices)

# the packed row types the kernels are instantiated for, as they number
# them
PACKED_DTYPES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1}
# the modes of hash_encode_packed_fwd, as the kernel numbers them: the
# unpacked levels' lookup (all 8 corners, the one sampled corner, or the
# sampled face's 4 rows)
_PACKED_MODES = {"exact": 0, "probe": 1, "face": 2}
# the most packed rows the kernels take (row indices are 32-bit, byte
# offsets size_t)
_PACKED_MAX_ROWS = 2 ** 28
# the stored row dtypes by RenderConfig's names
ROW_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
# fp8 e4m3's largest finite value is 448; the JAX package's cast rounds
# |x| up to 464 to it (ties to even) and gives NaN beyond and for ±inf,
# where torch's saturates to ±448
_FP8_ROUNDS_TO_MAX = 464.0


def choose_n_packed(spec: HashGridSpec, max_entries: int) -> int:
    """How many leading levels have res³ cells within max_entries
    (resolutions grow, so the packable levels are a prefix)."""
    n = 0
    for res in spec.resolutions:
        if res ** 3 > max_entries:
            break
        n += 1
    return n


def packed_offsets(spec: HashGridSpec, n_packed: int):
    """(each packed level's first row, the total row count)."""
    offs, total = [], 0
    for lvl in range(n_packed):
        offs.append(total)
        total += spec.resolutions[lvl] ** 3
    return tuple(offs), total


_ROW_OFFSETS = {}


def _row_offsets(spec: HashGridSpec, n_packed: int, device) -> torch.Tensor:
    """int32 [max(n_packed, 1)]: each packed level's first row in the
    packed table, on the device, built once per (spec, n_packed, device)."""
    key = (spec, n_packed, str(device))
    if key not in _ROW_OFFSETS:
        offs = packed_offsets(spec, n_packed)[0]
        _ROW_OFFSETS[key] = torch.tensor(offs or [0], dtype=torch.int32,
                                         device=device)
    return _ROW_OFFSETS[key]


def _clipped_cell(x: torch.Tensor, res: int):
    """A packed level's cell of points x [N, 3] in [0, 1]: (cell [N, 3]
    int64, clip(floor(x·res), 0, res − 1), and frac = x·res − cell). At
    x = 1 the far corners weigh 1: the vertices the unpacked clamp lands
    on."""
    pos = x * res
    cell = torch.floor(pos).to(torch.int64).clamp(0, res - 1)
    return cell, pos - cell.float()


def packed_cell_rows(x01: torch.Tensor, spec: HashGridSpec,
                     n_packed: int) -> torch.Tensor:
    """[N, n_packed] int64: the packed table's row that each point reads on
    each packed level (its clipped cell's row, z-major)."""
    offs, _ = packed_offsets(spec, n_packed)
    rows = [torch.zeros((x01.shape[0], 0), dtype=torch.int64,
                        device=x01.device)]
    for lvl in range(n_packed):
        res = spec.resolutions[lvl]
        c = _clipped_cell(x01.float(), res)[0]
        rows.append(((c[:, 2] * res + c[:, 1]) * res + c[:, 0]
                     + offs[lvl])[:, None])
    return torch.cat(rows, dim=1)


@dataclass
class PackedTable:
    """data: [total cells, 8·F] rows of levels [0, n_packed), bf16 or
    float8_e4m3fn."""
    data: torch.Tensor
    n_packed: int


def row_dtype(dtype) -> torch.dtype:
    """A row dtype from RenderConfig's name ("bf16" | "fp8") or a torch
    dtype."""
    dtype = ROW_DTYPES.get(dtype, dtype)
    if dtype not in PACKED_DTYPES:
        raise ValueError(f"packed row dtype: expected 'bf16', 'fp8' or one "
                         f"of {list(PACKED_DTYPES)}, got {dtype!r}")
    return dtype


def _to_rows(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 values → the row dtype, as the JAX package's astype: round to
    nearest even; fp8 NaN (its sign kept) where |v| > 464 or v is ±inf."""
    out = v.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return out
    nan = torch.where(torch.signbit(v), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(v.abs() > _FP8_ROUNDS_TO_MAX, nan,
                       out.view(torch.uint8)).view(dtype)


def _vertex_grid(table: torch.Tensor, spec: HashGridSpec, lvl: int,
                 dtype) -> torch.Tensor:
    """[res+1, res+1, res+1, F] vertex features of one level, indexed
    [z, y, x], as the unpacked lookup reads them (the hashed levels' vertices
    hashed), in the row dtype."""
    res, off = spec.resolutions[lvl], spec.offsets[lvl]
    s = res + 1
    if not spec.hashed[lvl]:
        v = table[off:off + s ** 3]
    else:
        ax = torch.arange(s, dtype=torch.int64, device=table.device)
        idx = _hash_index(ax[None, None, :], ax[None, :, None],
                          ax[:, None, None], res, spec.sizes[lvl], True)
        v = table[off + idx.reshape(-1)]
    return _to_rows(v.float(), dtype).reshape(s, s, s, -1)


def _cell_pack(v: torch.Tensor, res: int) -> torch.Tensor:
    """[res+1, ..., F] vertex grid → [res³, 8·F] cell rows, corner-major."""
    parts = [v[cz:cz + res, cy:cy + res, cx:cx + res]
             for cx, cy, cz in _CORNERS]
    return torch.stack(parts, dim=3).reshape(res ** 3, 8 * v.shape[-1])


def build_packed_table_plain(table: torch.Tensor, spec: HashGridSpec,
                             n_packed: int, dtype=torch.bfloat16
                             ) -> PackedTable:
    """Plain version of the pack_table kernel: levels [0, n_packed) of the
    f32 table [T, F] relaid as cell rows of the row dtype."""
    dtype = row_dtype(dtype)
    blocks = [_cell_pack(_vertex_grid(table, spec, lvl, dtype),
                         spec.resolutions[lvl]) for lvl in range(n_packed)]
    if not blocks:
        return PackedTable(torch.zeros((0, 8 * spec.n_features), dtype=dtype,
                                       device=table.device), 0)
    return PackedTable(torch.cat(blocks), n_packed)


def build_packed_table(table: torch.Tensor, spec: HashGridSpec,
                       n_packed: int, dtype=torch.bfloat16) -> PackedTable:
    """The f32 table [T, F] → PackedTable of levels [0, n_packed), rows of
    `dtype` (bf16 or fp8, or their names). CUDA tensors launch pack_table;
    CPU tensors take build_packed_table_plain."""
    dtype = row_dtype(dtype)
    if not table.is_cuda:
        return build_packed_table_plain(table, spec, n_packed, dtype)
    if spec.n_features not in _KERNEL_FEATURES:
        raise ValueError(f"pack_table is built for n_features in "
                         f"{_KERNEL_FEATURES}, got {spec.n_features}")
    rows = packed_offsets(spec, n_packed)[1]
    if not 0 <= n_packed <= spec.n_levels <= _KERNEL_MAX_LEVELS \
            or rows > _PACKED_MAX_ROWS:
        raise ValueError(f"pack_table takes at most {_KERNEL_MAX_LEVELS} "
                         f"levels and {_PACKED_MAX_ROWS} rows, got n_packed "
                         f"{n_packed} of {spec.n_levels} levels, {rows} rows")
    kernels.check(table, "table", torch.float32,
                  (spec.table_size, spec.n_features))
    data = torch.empty((rows, 8 * spec.n_features), dtype=dtype,
                       device=table.device)
    if rows:
        kernels.launch("pack_table", table, _level_meta(spec, table.device),
                       _row_offsets(spec, n_packed, table.device),
                       data, rows, spec.n_levels, n_packed, spec.n_features,
                       PACKED_DTYPES[dtype])
    return PackedTable(data, n_packed)


def _packed_level(data: torch.Tensor, rows: torch.Tensor, res: int,
                  x: torch.Tensor, n_features: int) -> torch.Tensor:
    """One packed level's features [N, F] bf16: each point's row of its
    clipped cell (rows [N], packed_cell_rows) blended with the trilinear
    weights of its frac."""
    frac = _clipped_cell(x, res)[1]
    corners = data[rows].float().reshape(x.shape[0], 8, n_features)
    return _blend(corners, _corner_weights(frac))


def hash_encode_packed_plain(table_bf16: torch.Tensor, packed: PackedTable,
                             x01: torch.Tensor, spec: HashGridSpec,
                             mode: str = "exact") -> torch.Tensor:
    """Plain version of the hash_encode_packed_fwd kernel: [N, L·F] bf16.
    The packed levels [0, k) read one row each; the others take mode's
    lookup of table_bf16: "exact" the 8 corners (the JAX package's
    hash_encode_packed, bit-equal to hash_encode with bf16 rows), "probe"
    the one corner sampled_corner_indices draws (hash_encode_packed_probe),
    "face" the sampled face's 4 rows (hash_encode_packed_face). Every level
    blends as hash_encode_plain does: weights rounded to bf16, exact f32
    products summed in order, one rounding. At k = 0 the probe and face
    modes are hash_encode_sampled and hash_encode_face, at k = L every mode
    is the exact one: the JAX package's branches for those k."""
    n, f, k = x01.shape[0], spec.n_features, packed.n_packed
    x = x01.float()
    cells = packed_cell_rows(x, spec, k)
    if mode == "probe" and k < spec.n_levels:
        chosen = sampled_corner_indices(x, spec, range(k, spec.n_levels))
    if mode == "face":
        u = _corner_uniform(x, spec.n_levels)
    feats = []
    for lvl in range(spec.n_levels):
        res, size = spec.resolutions[lvl], spec.sizes[lvl]
        hashed, off = spec.hashed[lvl], spec.offsets[lvl]
        if lvl < k:
            feats.append(_packed_level(packed.data, cells[:, lvl], res, x,
                                       f))
        elif mode == "exact":
            idx, w = _level_indices(x, res, size, hashed)
            feats.append(_blend(table_bf16[idx + off].float(), w))
        elif mode == "probe":
            feats.append(table_bf16[chosen[:, lvl - k]])
        elif mode == "face":
            idx, w = _level_face_rows(x, res, size, hashed, u[:, lvl])
            feats.append(_blend(table_bf16[idx + off].float(), w))
        else:
            raise ValueError(f"mode: expected 'exact', 'probe' or 'face', "
                             f"got {mode!r}")
    return torch.cat(feats, dim=1).reshape(n, spec.out_dim)


def hash_encode_packed(table_bf16: torch.Tensor, packed: PackedTable,
                       x01: torch.Tensor, spec: HashGridSpec,
                       mode: str = "exact") -> torch.Tensor:
    """The encode through a cell-packed table: each of the packed levels
    [0, packed.n_packed) reads its one row of the cell's 8 corners'
    features (bf16 or fp8) and blends them exactly; the other levels take
    mode's lookup of table_bf16: "exact" all 8 corners (the JAX package's
    hash_encode_packed), "probe" the one sampled corner
    (hash_encode_packed_probe), "face" the sampled face's 4 rows
    (hash_encode_packed_face). x01 [N, 3] f32 → [N, L·F] bf16. CUDA tensors
    launch hash_encode_packed_fwd; CPU tensors take
    hash_encode_packed_plain."""
    if mode not in _PACKED_MODES:
        raise ValueError(f"mode: expected one of {sorted(_PACKED_MODES)}, "
                         f"got {mode!r}")
    if not x01.is_cuda:
        return hash_encode_packed_plain(table_bf16, packed, x01, spec, mode)
    _check_kernel_args("hash_encode_packed_fwd", x01, spec)
    n, k = x01.shape[0], packed.n_packed
    kernels.check(table_bf16, "table_bf16", torch.bfloat16,
                  (spec.table_size, spec.n_features), x01.device)
    data = packed.data
    rows = sum(r ** 3 for r in spec.resolutions[:k])
    if data.dtype not in PACKED_DTYPES:
        raise ValueError(f"packed rows: dtype {data.dtype}, expected "
                         f"bfloat16 or float8_e4m3fn")
    if not 0 <= k <= spec.n_levels or rows > _PACKED_MAX_ROWS:
        raise ValueError(f"n_packed {k} of {spec.n_levels} levels, {rows} "
                         f"rows: the kernel takes at most "
                         f"{_PACKED_MAX_ROWS}")
    kernels.check(data, "packed.data", data.dtype,
                  (rows, 8 * spec.n_features), x01.device)
    if data.data_ptr() % 16:
        raise ValueError("packed.data: rows are read as 16-byte pieces, "
                         "its start must be 16-byte aligned")
    out = torch.empty((n, spec.out_dim), dtype=torch.bfloat16,
                      device=x01.device)
    if n:
        kernels.launch("hash_encode_packed_fwd", table_bf16, data,
                       _row_offsets(spec, k, x01.device), x01,
                       _level_meta(spec, x01.device), out, n, spec.n_levels,
                       spec.n_features, k, _PACKED_MODES[mode],
                       PACKED_DTYPES[data.dtype])
    return out


class PackedTableCache:
    """The render's packed table of one model, packed once per version of
    its table (keyed, as HashGridEncoding.table_bf16, on the table's data
    pointer, version counter and device) and per (budget, row dtype) of the
    config asked for: a render config swapped after the first pack repacks.
    None where the budget is ≤ 0 or no level fits it. The caller decides
    whether packing engages on the device (ops.renderer.packing_enabled)."""

    def __init__(self, model):
        self.model = model
        self.clear()

    def clear(self):
        """Forget the packed table: the next call packs anew."""
        self._key = None
        self._packed = None

    def __call__(self, cfg) -> PackedTable | None:
        table = self.model.encoder.table
        if cfg.packed_max_entries <= 0:
            return None
        key = (table.data_ptr(), table._version, table.device,
               cfg.packed_max_entries, cfg.packed_dtype)
        if key != self._key:
            packed = self.model.pack_table(cfg.packed_max_entries,
                                           cfg.packed_dtype)
            self._packed = packed if packed.n_packed else None
            self._key = key
        return self._packed
