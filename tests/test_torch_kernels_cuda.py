"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch sees no CUDA device (the kernels have
no CPU mode). On a GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -q

chip_smoke.py runs the same comparisons at the full render path's shapes.
"""

import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu_torch import kernels
from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
from ucsa_neural_rendering_tpu_torch.ops import placement as pl
from ucsa_neural_rendering_tpu_torch.ops.renderer import (RenderConfig,
                                                          render_rays_staged)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rays(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _grid(r, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    occ = torch.rand((r, r, r), generator=g) > 0.5
    return torch.where(occ, 20 * torch.rand((r, r, r), generator=g),
                       torch.full((r, r, r), 1e-3)).to(dev)


@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_fwd_matches_plain(dev, n_features):
    """Bit-equal: both sum the same exact f32 products in the same order."""
    spec = he.make_spec(8, n_features, 15, 16, he.ngp_per_level_scale(1.0, 8))
    g = torch.Generator().manual_seed(0)
    table = (torch.rand((spec.table_size, n_features), generator=g) * 2 - 1)
    tb = table.to(dev).to(torch.bfloat16)
    x01 = torch.rand((10007, 3), generator=g).to(dev)
    out = he.hash_encode(tb, x01, spec)
    torch.testing.assert_close(out, he.hash_encode_plain(tb, x01, spec),
                               rtol=0, atol=0)


@pytest.mark.parametrize("proposal", [False, True])
def test_occ_placement_matches_plain(dev, proposal):
    """Inverse-CDF in another summation order: atol 1e-3 on z ≤ ~2."""
    o, d = _rays(1000, dev)
    args = (o, d, _grid(32, dev), 1.0, 16, 128, 0.2, proposal, 0.01, 0.01,
            1.0)
    z = pl.occ_placement(*args)
    ref = pl.occ_placement_plain(*args)
    assert (z[:, 1:] >= z[:, :-1]).all()
    torch.testing.assert_close(z, ref, rtol=1e-5, atol=1e-3)
    assert (z - ref).abs().mean() < 1e-5


def test_importance_resample_matches_plain(dev):
    g = torch.Generator().manual_seed(2)
    z = torch.sort(torch.rand((1000, 24), generator=g) * 3 + 0.2).values
    sigma = torch.exp(torch.randn((1000, 24), generator=g) * 2)
    z, sigma = z.to(dev), sigma.to(dev)
    nz, zs, order = pl.importance_resample(z, sigma, 16)
    rnz, rzs, rorder = pl.importance_resample_plain(z, sigma, 16)
    torch.testing.assert_close(nz, rnz, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(zs, rzs, rtol=1e-5, atol=1e-3)
    assert torch.equal(torch.take_along_dim(torch.cat([z, nz], -1), order,
                                            -1), zs)
    assert (order == rorder).all(-1).float().mean() > 0.98


def test_composite_fwd_matches_plain(dev):
    """f32 sums in another order: atol 1e-5 (rgb, semantics), 1e-4 depth."""
    g = torch.Generator().manual_seed(3)
    n, t, c = 1000, 64, 40
    z = torch.sort(torch.rand((n, t), generator=g) * 3 + 0.2).values
    sigma = torch.exp(torch.randn((n, t), generator=g) * 2)
    sigma[:4] = 0.0
    sigma[4:8] = 1e30
    rgb = torch.rand((n, t, 3), generator=g)
    sem = torch.softmax(torch.randn((n, t, c), generator=g), -1)
    dn = 1 + torch.rand((n,), generator=g)
    args = [a.to(dev) for a in (z, sigma, rgb, sem, dn)]
    out = cp.composite_fwd(*args)
    ref = cp.composite_fwd_plain(*args)
    for a, b, tol in zip(out, ref, (1e-5, 1e-5, 1e-4)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


def test_render_goes_through_every_kernel(dev):
    """A small staged early-stop render launches all four kernels and
    agrees with the plain path on the card."""
    model = SemanticNeRF(bound=1.0, num_semantic_classes=6, n_levels=8,
                         n_features=4, log2_hashmap_size=15, device=dev)
    o, d = _rays(1000, dev, seed=4)
    dn = torch.ones(1000, device=dev)
    cfg = RenderConfig(num_steps=16, upsample_steps=16, early_stop=True,
                       stage1_steps=8, max_ray_batch=256)
    grid = _grid(32, dev)
    kernels.reset_launches()
    out = render_rays_staged(model, o, d, dn, cfg, grid)
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    kernels.reset_launches()
    with kernels.plain_versions():
        ref = render_rays_staged(model, o, d, dn, cfg, grid)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    for k in out:
        assert torch.isfinite(out[k]).all()
        assert (out[k] - ref[k]).abs().mean() < 1e-3, k
