"""The packed kernels' bench (bench/packed_kernels.py) and the L2 probe
(bench/dma_gather.py): the bytes and 32-byte sectors they count from
shapes, held to hand counts; and kernels.sources_from, which the bench
uses to time an earlier version of a kernel. No card: nothing here builds
or launches a kernel."""

import pytest
import torch

from ucsa_neural_rendering_tpu_torch import kernels
from ucsa_neural_rendering_tpu_torch.bench import dma_gather as dg
from ucsa_neural_rendering_tpu_torch.bench import packed_kernels as pk
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
from ucsa_neural_rendering_tpu_torch.models import packed_table as pt


def test_distinct_sectors_counts_within_each_warp():
    offs = torch.tensor([[0, 8, 24, 32, 72, 80, 96, 104],
                         [0, 0, 0, 0, 0, 0, 0, 31],
                         [0, 32, 64, 96, 128, 160, 192, 224]])
    assert pk._distinct_sectors(offs, warp=1) == 4 + 1 + 8
    assert pk._distinct_sectors(offs, warp=2) == 4 + 8
    assert pk._distinct_sectors(offs) == 8  # one warp: sectors 0–7
    assert pk._distinct_sectors(offs[:, :0]) == 0


def test_encode_work_by_hand():
    """One point at (0.1, 0.1, 0.1) on a dense level of res 2, F = 4 (rows
    of 8 bytes): its corners are rows 0, 1, 3, 4, 9, 10, 12, 13, in sectors
    0, 0, 0, 1, 2, 2, 3, 3 (4 distinct); packed, one fp8 row of 32 bytes."""
    spec = he.make_spec(1, 4, 12, 2, 1.5)
    assert spec.resolutions == (2,) and not spec.hashed[0]
    x = torch.full((1, 3), 0.1)
    exact = pk.encode_work(x, spec, 0, 32, "exact")
    assert exact["sectors"] == 4
    # a point in, its 4 features out, 8 distinct table rows of 8 bytes
    assert exact["bytes"] == 12 + 8 + 8 * 8
    probe = pk.encode_work(x, spec, 0, 32, "probe")
    assert probe["sectors"] == 1 and probe["bytes"] == 12 + 8 + 8
    face = pk.encode_work(x, spec, 0, 32, "face")
    assert face["bytes"] == 12 + 8 + 4 * 8 and 1 <= face["sectors"] <= 4
    packed = pk.encode_work(x, spec, 1, 32, "exact")
    assert packed["sectors"] == 1 and packed["bytes"] == 12 + 8 + 32
    assert pk.encode_work(x, spec, 1, 64, "face")["sectors"] == 2


@pytest.mark.parametrize("mode", ["exact", "probe", "face"])
def test_encode_work_at_the_shipped_geometry(mode):
    """The shipped 8 × 4 geometry with the step's three packed levels: the
    packed levels' sectors (2 a bf16 row), then at most mode's rows a
    level, fewer where a warp's points or the exact mode's x-pairs share
    sectors."""
    spec = pk.spec_of(8, 4)
    x = pk.ray_points(64, 8, torch.Generator().manual_seed(0))
    w = pk.encode_work(x, spec, 3, 64, mode)
    n, per = x.shape[0], {"exact": 8, "probe": 1, "face": 4}[mode]
    assert w["points"] == n and w["n_packed"] == 3
    assert n * 5 <= w["sectors"] <= n * (6 + 5 * per)
    if mode == "exact":
        assert w["sectors"] < n * (6 + 5 * 7)


def test_pack_work_at_the_shipped_geometry():
    """8 × 4, three levels packed: 920,790 rows; the fp8 rows' 29.5 MB
    written as whole sectors; the dense levels' vertices 17³ and 40³, the
    hashed level's its distinct hashed rows, each row of 16 bytes."""
    spec = pk.spec_of(8, 4)
    table = torch.zeros((spec.table_size, 4))
    w = pk.pack_work(table, spec, 3, 32)
    assert w["rows"] == 16 ** 3 + 39 ** 3 + 95 ** 3 == 920_790
    assert w["mb_written"] == pytest.approx(920_790 * 32 / 1e6)
    hashed = torch.unique(he._hash_index(*[
        torch.arange(96)[s] for s in ((None, None, slice(None)),
                                      (None, slice(None), None),
                                      (slice(None), None, None))],
        95, spec.sizes[2], True)).numel()
    vertices = 17 ** 3 + 40 ** 3 + hashed
    assert w["bytes"] == 920_790 * 32 + vertices * 16
    # the dense levels' rows run on from offset 0 and 4920 (2 rows a
    # sector); the hashed level's distinct rows share sectors in pairs
    assert 920_790 + (17 ** 3 + 40 ** 3 + hashed) // 2 <= w["sectors"] \
        <= 920_790 + 2 + (17 ** 3 + 40 ** 3) // 2 + 1 + hashed
    bf16 = pk.pack_work(table, spec, 3, 64)
    assert bf16["sectors"] - w["sectors"] == 920_790


def test_pack_work_of_the_launch_floor():
    spec = he.make_spec(1, 4, 12, 2, 1.5)
    w = pk.pack_work(torch.zeros((spec.table_size, 4)), spec, 1, 32)
    # 8 cells of 32 bytes; 27 vertex rows of 16 bytes in 14 sectors
    assert w == dict(rows=8, bytes=8 * 32 + 27 * 16, sectors=8 + 14,
                     mb_written=256 / 1e6, mb_vertices=27 * 16 / 1e6)


@pytest.mark.parametrize("row_bytes", dg.PROBE_ROW_BYTES)
@pytest.mark.parametrize("table_mb", dg.PROBE_TABLE_MB)
def test_probe_work(table_mb, row_bytes):
    w = dg.probe_work(table_mb, row_bytes, 1 << 21)
    assert w["t"] * row_bytes <= table_mb * 10 ** 6 < (w["t"] + 1) * row_bytes
    assert w["sectors_read"] == 1 << 21
    assert w["sectors_index"] == (1 << 21) * 4 // 32
    assert w["sectors_written"] == (1 << 21) * row_bytes // 32


def test_probe_work_rejects_rows_across_sectors():
    with pytest.raises(ValueError, match="sector"):
        dg.probe_work(8, 64, 16)
    with pytest.raises(ValueError, match="sector"):
        dg.probe_work(8, 12, 16)


def test_l2_sector_rate_takes_the_fastest_inside_l2():
    rows = [dict(table_mb=8, sectors_per_s=1.0),
            dict(table_mb=25, sectors_per_s=3.0),
            dict(table_mb=55, sectors_per_s=9.0)]
    assert dg.l2_sector_rate(rows) == 3.0


def test_the_benches_need_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        dg.measure_sector_rate(device="cpu")
    with pytest.raises(RuntimeError, match="card"):
        pk.measure("cpu")


def test_bench_shapes_are_the_main_paths():
    """The encode shapes' points (4096 rays of the call's samples) and
    n_packed at each budget: the render's fp8 rows and the step's bf16
    rows pack levels 0–2 at 8 × 4; 0–6 and 0–5 at 16 × 2."""
    pts = {label: 4096 * s for label, *_, s in pk.ENCODE_SHAPES}
    assert pts["test stage 1"] == 65_536 and pts["predict stage 1"] == 32_768
    assert pts["step coarse exact"] == 98_304 and pts["step new face"] == 32_768
    for label, levels, features, (budget, _) in pk.PACK_SHAPES:
        k = pt.choose_n_packed(pk.spec_of(levels, features), budget)
        assert k == {(8, 4): 3, (16, 2): 7 if budget == 2 ** 23 else 6}[
            (levels, features)], label


def test_sources_from_sets_and_restores(tmp_path):
    (tmp_path / "pack_table.cu").write_text("// an earlier version\n")
    assert "pack_table" not in kernels._SOURCE_DIRS
    with kernels.sources_from(tmp_path, ["pack_table"]):
        assert kernels._SOURCE_DIRS["pack_table"] == tmp_path.resolve()
        assert kernels._lib_path("pack_table", tmp_path) != \
            kernels._lib_path("pack_table")
    assert "pack_table" not in kernels._SOURCE_DIRS
    with pytest.raises(FileNotFoundError, match="hash_encode_packed_fwd"):
        with kernels.sources_from(tmp_path, ["pack_table",
                                             "hash_encode_packed_fwd"]):
            pass
    assert not kernels._SOURCE_DIRS


@pytest.mark.parametrize("window", ["whole", "one_lost"])
def test_device_ms_counts_a_lost_counted_call_by_its_launches(monkeypatch,
                                                              window):
    """A profile whose counted call lost its device operation but kept its
    launch (as an H100's profiler did, ROADMAP F6): with the window whole
    (a launch and an operation for each of the iters calls) device_ms
    takes k from the launches and times the window; with one of the
    window's operations lost too, the profile is short, taken again, and
    five such raise."""
    import time
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from ucsa_neural_rendering_tpu_torch import bench

    ids = iter(range(100, 1000))

    def event(device, name, id, us=0.0):
        return SimpleNamespace(name=name, device_type=device, id=id,
                               is_user_annotation=False,
                               time_range=SimpleNamespace(
                                   elapsed_us=lambda: us))

    def launch(us, keep=True):
        i = next(ids)
        host = event(DeviceType.CPU, "cuLaunchKernel", i)
        return [host, event(DeviceType.CUDA, "kernel", i, us)] if keep \
            else [host]

    def mark():
        return event(DeviceType.CPU, "cudaEventRecordWithFlags", next(ids))

    iters = 4
    events = (launch(9.0) + [mark()] + launch(5.0, keep=False) + [mark()]
              + [e for c in range(iters)
                 for e in launch(5.0, keep=window == "whole" or c)]
              + [mark()])

    class FakeProfile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def events(self):
            return events

    class FakeEvent:
        def record(self):
            pass

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(time, "sleep", lambda _: None)
    monkeypatch.setattr(bench, "PROFILES",
                        {"taken": 0, "short": 0, "recounted": 0})
    if window == "whole":
        assert bench.device_ms(lambda: None, iters=iters, warmup=0) \
            == pytest.approx(5e-3)
        assert bench.PROFILES == {"taken": 1, "short": 0, "recounted": 1}
        return
    with pytest.raises(RuntimeError, match=r"k = 0, 3 in the window"):
        bench.device_ms(lambda: None, iters=iters, warmup=0)
    assert bench.PROFILES == {"taken": bench.PROFILE_TRIES,
                              "short": bench.PROFILE_TRIES, "recounted": 0}
