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


@pytest.mark.parametrize("path", MODULES, ids=lambda p: _module_name(p))
def test_module_names_no_jax(path):
    """No import statement of a port module names jax, its libraries or the
    JAX package (the name `ucsa_neural_rendering_tpu_torch` itself is
    allowed)."""
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
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import init_grid
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer
    import numpy as np
    small = dict(bound=1.0, num_semantic_classes=3, n_levels=2,
                 log2_hashmap_size=10)
    return {
        "SemanticNeRF": lambda **kw: SemanticNeRF(**small, **kw),
        "NeRFTrainer": lambda **kw: NeRFTrainer(
            SemanticNeRF(**small, device="cpu"), image_hw=(2, 2), **kw),
        "init_grid": lambda **kw: init_grid(**kw),
        "get_rays": lambda **kw: get_rays(
            np.eye(4, dtype=np.float32), [2.0, 2.0, 1.0, 1.0], 2, 2, **kw),
    }


@pytest.mark.parametrize("name", ["SemanticNeRF", "NeRFTrainer", "init_grid",
                                  "get_rays"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Without a card, an entry point called with its default device
    raises; with device="cpu" it runs on the CPU."""
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
               "NeRFTrainer": lambda o: list(o.model.parameters())}[name](out)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_kernel_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers never build or launch a kernel."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.ops import (composite_fwd,
                                                     importance_resample,
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
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert not kernels._LIBS


def test_plain_versions_swaps_every_call_site_and_restores():
    """kernels.plain_versions() points each call site of the render path at
    its kernel's plain version, and puts the wrappers back on leaving, on an
    error too."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops import renderer as rr
    sites = {(he, "hash_encode"): he.hash_encode_plain,
             (rr, "occ_placement"): pl.occ_placement_plain,
             (rr, "importance_resample"): pl.importance_resample_plain,
             (rr, "composite_fwd"): cp.composite_fwd_plain}
    wrappers = {site: getattr(*site) for site in sites}
    with pytest.raises(KeyError):
        with kernels.plain_versions():
            for site, plain in sites.items():
                assert getattr(*site) is plain
            raise KeyError("leave the block")
    for site, fn in wrappers.items():
        assert getattr(*site) is fn
