"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ucsa_neural_rendering_tpu_torch as port

PKG = Path(port.__file__).resolve().parent
MODULES = sorted(p for p in PKG.rglob("*.py"))
# the port's smoke run on the card, at the repository's root
CHIP_SMOKE = PKG.parent / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "ucsa_neural_rendering_tpu")


def _module_name(path: Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_port_imports_without_jax():
    """Import every port module in a fresh interpreter where jax (and the
    JAX package) cannot be imported at all."""
    names = [_module_name(p) for p in MODULES]
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        "import importlib",
        f"for name in {names!r}:",
        "    importlib.import_module(name)",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", MODULES + [CHIP_SMOKE],
                         ids=lambda p: _module_name(p))
def test_module_names_no_jax(path):
    """No import statement of a port module or of chip_smoke.py names jax,
    its libraries or the JAX package (the name
    `ucsa_neural_rendering_tpu_torch` itself is allowed)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {name}"


def _entry_points():
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.models.semantic_nerf import (
        _FusedStyleMLP)
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import init_grid
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer
    import numpy as np
    small = dict(bound=1.0, num_semantic_classes=3, n_levels=2,
                 log2_hashmap_size=10)
    return {
        "SemanticNeRF": lambda **kw: SemanticNeRF(**small, **kw),
        "HashGridEncoding": lambda **kw: he.HashGridEncoding(
            he.make_spec(2, 2, 10, 16, 1.5), **kw),
        "_FusedStyleMLP": lambda **kw: _FusedStyleMLP(15, 64, 1, 3, **kw),
        "NeRFTrainer": lambda **kw: NeRFTrainer(
            SemanticNeRF(**small, device="cpu"), image_hw=(2, 2), **kw),
        "init_grid": lambda **kw: init_grid(**kw),
        "get_rays": lambda **kw: get_rays(
            np.eye(4, dtype=np.float32), [2.0, 2.0, 1.0, 1.0], 2, 2, **kw),
    }


@pytest.mark.parametrize("name", ["SemanticNeRF", "NeRFTrainer", "init_grid",
                                  "get_rays", "HashGridEncoding",
                                  "_FusedStyleMLP"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Without a card, an entry point (or a module the model is built of)
    called with its default device raises; with device="cpu" it runs on the
    CPU."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(device="cuda")
    out = make(device="cpu")
    tensors = {"init_grid": lambda o: [o],
               "get_rays": lambda o: list(o.values()),
               "SemanticNeRF": lambda o: list(o.parameters()),
               "HashGridEncoding": lambda o: list(o.parameters()),
               "_FusedStyleMLP": lambda o: list(o.parameters()),
               "NeRFTrainer": lambda o: list(o.model.parameters())}[name](out)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_kernel_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers never build or launch a kernel."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench.dma_gather import dma_gather
    from ucsa_neural_rendering_tpu_torch.models import (hash_encode_bwd,
                                                        hash_encode_sampled,
                                                        make_spec, mlp_bwd,
                                                        mlp_fwd)
    from ucsa_neural_rendering_tpu_torch.ops import (composite_bwd,
                                                     composite_fwd,
                                                     importance_resample,
                                                     occ_grid_update,
                                                     occ_placement)
    kernels.reset_launches()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    z = occ_placement(o, d, torch.ones((8, 8, 8)), 1.0, 8, 16)
    new_z, z_all, order = importance_resample(z, torch.ones_like(z), 4)
    sigma = torch.ones_like(z_all)
    image, sem, depth = composite_fwd(z_all, sigma,
                                      torch.rand(4, 12, 3),
                                      torch.rand(4, 12, 5), torch.ones(4))
    assert image.shape == (4, 3) and sem.shape == (4, 5)
    d_sigma, _, _ = composite_bwd(z_all, sigma, torch.rand(4, 12, 3),
                                  torch.rand(4, 12, 5), torch.ones(4),
                                  torch.ones(4, 3), torch.ones(4, 5),
                                  torch.ones(4))
    assert d_sigma.shape == (4, 12)
    spec = make_spec(2, 2, 10, 16, 1.5)
    x01 = torch.rand(6, 3)
    assert hash_encode_bwd(x01, torch.ones(6, 4, dtype=torch.bfloat16), spec,
                           True).shape == (spec.table_size, 2)
    assert hash_encode_sampled(torch.ones(spec.table_size, 2,
                                          dtype=torch.bfloat16),
                               x01, spec).shape == (6, 4)
    assert occ_grid_update(torch.ones((8, 8, 8)), torch.zeros(128), 128,
                           0.5).shape == (8, 8, 8)
    weights = [torch.rand(64, 15), torch.rand(5, 64)]
    x = torch.rand(6, 15, dtype=torch.bfloat16)
    assert mlp_fwd(x, weights).shape == (6, 5)
    dx, dws = mlp_bwd(x, weights, torch.ones(6, 5, dtype=torch.bfloat16))
    assert dx.shape == (6, 15) and [w.shape for w in dws] == [(64, 15),
                                                                (5, 64)]
    table = torch.rand(10, 2)
    assert torch.equal(dma_gather(table, torch.tensor([3, 0, 9],
                                                      dtype=torch.int32)),
                       table[[3, 0, 9]])
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert not kernels._LIBS


def test_plain_versions_swaps_every_call_site_and_restores():
    """kernels.plain_versions() points each call site of the render and
    training paths at its kernel's plain version, one site per kernel of
    those paths (every kernel but the gather benchmark's), and puts the
    wrappers back on leaving, on an error too; plain_versions(*names)
    swaps only the sites named."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as sn
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    from ucsa_neural_rendering_tpu_torch.ops import occupancy as oc
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops import renderer as rr
    sites = {(he, "hash_encode"): he.hash_encode_plain,
             (he, "hash_encode_bwd"): he.hash_encode_bwd_plain,
             (he, "hash_encode_sampled"): he.hash_encode_sampled_plain,
             (sn, "mlp_fwd"): sn.mlp_fwd_plain,
             (sn, "mlp_bwd"): sn.mlp_bwd_plain,
             (rr, "occ_placement"): pl.occ_placement_plain,
             (rr, "importance_resample"): pl.importance_resample_plain,
             (cp, "composite_fwd"): cp.composite_fwd_plain,
             (cp, "composite_bwd"): cp.composite_bwd_plain,
             (oc, "occ_grid_update"): oc.occ_grid_update_plain}
    # one site per kernel but dma_gather (only its benchmark calls it)
    assert len(sites) == len(kernels._CALL_SITES) == \
        len(kernels.SIGNATURES) - 1
    wrappers = {site: getattr(*site) for site in sites}
    with pytest.raises(KeyError):
        with kernels.plain_versions():
            for site, plain in sites.items():
                assert getattr(*site) is plain
            raise KeyError("leave the block")
    for site, fn in wrappers.items():
        assert getattr(*site) is fn
    with kernels.plain_versions("mlp_fwd", "mlp_bwd"):
        for site, plain in sites.items():
            swapped = site[1] in ("mlp_fwd", "mlp_bwd")
            assert (getattr(*site) is plain) == swapped
    for site, fn in wrappers.items():
        assert getattr(*site) is fn
    with pytest.raises(ValueError, match="dma_gather"):
        with kernels.plain_versions("dma_gather"):
            pass


@pytest.mark.parametrize("lost", ["no_device_events", "the_counted_call",
                                  "some_timed_events", "the_window",
                                  "the_count_range", "every_try"])
def test_device_ms_retakes_a_profile_that_lost_device_events(monkeypatch,
                                                             lost):
    """device_ms counts the device operations of one call (k, in its COUNT
    range, after a first call whose operations the profiler may lose) and
    times those in the WINDOW range; a profile that lost a range, the
    counted call or some of the timed calls' operations (here 7 of 4 calls
    × 2) is taken again, and when every try comes back short it raises."""
    import time
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from ucsa_neural_rendering_tpu_torch import bench

    def event(us, start, device=DeviceType.CUDA, name="kernel"):
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=False,
                               time_range=SimpleNamespace(
                                   start=start, elapsed_us=lambda: us))

    # the parts as the host's clock (µs) sees them, GAP_S apart
    gap = 1e6 * bench.GAP_S
    count = event(0.0, gap, DeviceType.CPU, bench.COUNT)
    window = event(0.0, 2 * gap, DeviceType.CPU, bench.WINDOW)
    first = [event(9.0, 5.0)]                       # may be lost: not counted
    # k = 2 operations a call; the first mapped a little before its range
    counted = [event(7.0, gap - 50.0), event(7.0, gap + 5.0)]
    timed = [event(3.0, 2 * gap + 5.0)] * 8         # 4 calls × 2
    good = first + [count] + counted + [window] + timed
    short = {"no_device_events": [count, window],
             "the_counted_call": first + [count, window] + timed,
             "some_timed_events": good[:-1],
             "the_window": first + [count] + counted + timed,
             "the_count_range": first + counted + [window] + timed,
             "every_try": good[:-1]}[lost]

    profiles = []

    class FakeProfile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def events(self):
            return profiles.pop(0)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(time, "sleep", lambda _: None)
    calls = []
    if lost == "every_try":
        profiles[:] = [short] * bench.PROFILE_TRIES
        with pytest.raises(RuntimeError, match="k = 2, 7 in the window"):
            bench.device_ms(lambda: calls.append(1), iters=4, warmup=0)
        assert len(calls) == bench.PROFILE_TRIES * (2 + 4) and not profiles
        return
    profiles[:] = [short, good]
    assert bench.device_ms(lambda: calls.append(1), iters=4,
                           warmup=1) == pytest.approx(6e-3)
    assert len(calls) == 1 + 2 * (2 + 4) and not profiles
    # by name: the window's operations of each name, per call
    split = good[:-4] + [event(1.0, 2 * gap + 5.0, name="reduce")] * 4
    profiles[:] = [split]
    assert bench.device_ms(lambda: None, iters=4, warmup=0, by_name=True) \
        == pytest.approx({"kernel": 3e-3, "reduce": 1e-3})


def test_gather_benchmark_needs_the_card(monkeypatch):
    """The gather benchmark measures the card: without one it raises, and
    it refuses the CPU."""
    from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bg.measure(m=8, t=4)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bg.measure(m=8, t=4, device="cpu")
