"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch sees no CUDA device (the kernels have
no CPU mode). On a GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -q

chip_smoke.py runs the same comparisons at the full render and training
paths' shapes.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu_torch import kernels
from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as sn
from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
from ucsa_neural_rendering_tpu_torch.ops import occupancy as oc
from ucsa_neural_rendering_tpu_torch.ops import placement as pl
from ucsa_neural_rendering_tpu_torch.ops.renderer import (RenderConfig,
                                                          render_rays_staged)
from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

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


def _table(spec, dev, seed):
    g = torch.Generator().manual_seed(seed)
    table = torch.rand((spec.table_size, spec.n_features), generator=g) * 2 - 1
    return table.to(dev).to(torch.bfloat16), g


@pytest.mark.parametrize("n", [1, 33, 10007])
@pytest.mark.parametrize("levels,n_features", [(3, 2), (3, 4), (16, 2),
                                               (16, 4), (32, 4)])
def test_hash_encode_fwd_levels_and_ragged_n(dev, levels, n_features, n):
    """Bit-equal to the plain version at N not a multiple of a block's 32
    points, with levels that share a warp (16, 32: two and four a warp) and
    output rows that are not whole 16-byte pieces (3 levels × F = 2: 12
    bytes)."""
    spec = he.make_spec(levels, n_features, 14, 16,
                        he.ngp_per_level_scale(1.0, levels))
    tb, g = _table(spec, dev, seed=levels + n)
    x01 = torch.rand((n, 3), generator=g).to(dev)
    torch.testing.assert_close(he.hash_encode(tb, x01, spec),
                               he.hash_encode_plain(tb, x01, spec),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_fwd_crowded_warp(dev, n_features):
    """Every point of many warps in one cell of the finest level (all the
    lanes of a warp gather the same 8 rows at every level), then a crowded
    half as in the backward's test: bit-equal."""
    spec = he.make_spec(8, n_features, 15, 16, he.ngp_per_level_scale(1.0, 8))
    tb, g = _table(spec, dev, seed=3)
    one_cell = 0.5 + 1e-5 * torch.rand((4096, 3), generator=g)
    x01 = torch.cat([one_cell, _crowded_points(10007, seed=4)[0]]).to(dev)
    torch.testing.assert_close(he.hash_encode(tb, x01, spec),
                               he.hash_encode_plain(tb, x01, spec),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_fwd_level_sizes_not_powers_of_two(dev, n_features):
    """Hashed levels of 3001 rows take the `idx % size` path (make_spec's
    hashed levels are 2^k rows, taken with a mask): bit-equal."""
    spec = he.make_spec(8, n_features, 15, 16, he.ngp_per_level_scale(1.0, 8))
    sizes = [3001 if h else s for s, h in zip(spec.sizes, spec.hashed)]
    offsets = [sum(sizes[:lvl]) for lvl in range(len(sizes))]
    spec = replace(spec, sizes=tuple(sizes), offsets=tuple(offsets))
    assert any(spec.hashed) and not all(spec.hashed)
    tb, g = _table(spec, dev, seed=5)
    x01 = torch.rand((10007, 3), generator=g).to(dev)
    torch.testing.assert_close(he.hash_encode(tb, x01, spec),
                               he.hash_encode_plain(tb, x01, spec),
                               rtol=0, atol=0)


def test_hash_encode_fwd_rejects_more_than_32_levels(dev):
    spec = he.make_spec(33, 2, 12, 16, 1.1)
    tb, _ = _table(spec, dev, seed=6)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="32 levels"):
        he.hash_encode(tb, torch.rand((5, 3), device=dev), spec)
    assert kernels.LAUNCHES["hash_encode_fwd"] == 0


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


def _resample_inputs(n, s1, seed):
    """Sorted z in [0.2, 3.2] and log-normal sigma, with rays of all-zero
    sigma (a uniform pdf), one of constant z and one whose z stop growing
    halfway: their bins there are flat, so new z equal coarse z exactly."""
    g = torch.Generator().manual_seed(seed)
    z = torch.sort(torch.rand((n, s1), generator=g) * 3 + 0.2).values
    sigma = torch.exp(torch.randn((n, s1), generator=g) * 2)
    sigma[:4] = 0.0
    z[4] = 2.0
    z[5, s1 // 2:] = z[5, s1 // 2]
    z[6] = torch.arange(s1, dtype=torch.float32)
    sigma[6] = 0.0
    return z, sigma


RESAMPLE_SHAPES = [(3, 1), (16, 16), (24, 8), (32, 32), (40, 33), (64, 64)]


# a cdf summed in another order: off by a few f32 ulps of values up to 1
CDF_EPS = 4 * 2.0 ** -23


def _new_z_within_reach(nz, z, sigma, u, rnz):
    """Holds the kernel's sorted new z to the plain version's: each within
    2e-3, except where a cdf error of CDF_EPS can move it further, and there
    within the plain sample's bin and its two neighbours; mean |Δ| 1e-5.
    Returns the share of samples so exempted.

    The inverse CDF moves z by the cdf's error times width / pdf (pdf = the
    bin's step of the cdf): past 2e-3 where width · 2·CDF_EPS / pdf > 2e-3
    (u − cdf_b and the denominator each off by CDF_EPS). z jumps by up to a
    bin where the pdf lies within 2·CDF_EPS of the denom < 1e-5 guard (the
    1e-5 weight floor's bins of a saturated ray hold 1e-5 / total, just
    below it), or where u lies within CDF_EPS of a bin edge. Bounds are
    nondecreasing in u, so the k-th smallest kernel value lies between the
    k-th smallest lower and upper bounds."""
    w = cp.composite_weights(z, sigma)[:, 1:-1] + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    last = cdf.shape[-1] - 1
    u = u.expand_as(rnz).contiguous()
    ind = torch.searchsorted(cdf, u, right=True)
    below, above = (ind - 1).clamp_min(0), ind.clamp_max(last)
    cb, ca = cdf.gather(-1, below), cdf.gather(-1, above)
    pdf = ca - cb
    width = bins.gather(-1, above) - bins.gather(-1, below)
    near = ((width * 2 * CDF_EPS > 2e-3 * pdf)
            | ((pdf - 1e-5).abs() <= 2 * CDF_EPS)
            | (u - cb < CDF_EPS) | (ca - u < CDF_EPS))
    lo = torch.where(near, torch.minimum(
        bins.gather(-1, (below - 1).clamp_min(0)), rnz - 2e-3), rnz - 2e-3)
    hi = torch.where(near, torch.maximum(
        bins.gather(-1, (above + 1).clamp_max(last)), rnz + 2e-3), rnz + 2e-3)
    lo, hi = torch.sort(lo, -1).values, torch.sort(hi, -1).values
    assert ((nz >= lo) & (nz <= hi)).all(), (nz - lo).min().item()
    dz = (nz - torch.sort(rnz, -1).values).abs()
    assert dz.mean() <= 1e-5, (dz.max().item(), dz.mean().item())
    return near.float().mean().item()


@pytest.mark.parametrize("keyed", [False, True], ids=["det", "random_u"])
@pytest.mark.parametrize("s1,s2", RESAMPLE_SHAPES)
def test_importance_resample_shapes_and_ties(dev, s1, s2, keyed):
    """A warp per ray at shapes below, at and above one warp of samples:
    new z sorted and within reach of the plain version's
    (_new_z_within_reach: the scans sum in another order); the order is
    exactly the stable argsort of the kernel's own [z, new_z] (coarse first
    on the exact ties of the flat rays) and, for det u, the plain order on
    >= 0.98 of rays."""
    n = 1000
    z, sigma = _resample_inputs(n, s1, seed=s1 * 100 + s2)
    u = torch.rand((n, s2), generator=torch.Generator().manual_seed(s2))
    z, sigma, u = z.to(dev), sigma.to(dev), u.to(dev) if keyed else None
    nz, zs, order = pl.importance_resample(z, sigma, s2, 1.0, u)
    rnz, rzs, rorder = pl.importance_resample_plain(z, sigma, s2, 1.0, u)
    assert all(torch.isfinite(a).all() for a in (nz, zs))
    assert (nz[:, 1:] >= nz[:, :-1]).all()
    near = _new_z_within_reach(nz, z, sigma,
                               pl.det_u(s2, dev) if u is None else u, rnz)
    assert near < 1e-3, near  # the 2e-3 limit holds on all but a few
    z_all = torch.cat([z, nz], -1)
    assert torch.equal(order, torch.sort(z_all, dim=-1, stable=True).indices)
    assert torch.equal(torch.take_along_dim(z_all, order, -1), zs)
    ties = (zs[:, 1:] == zs[:, :-1]) & (order[:, 1:] >= s1) \
        & (order[:, :-1] < s1)
    assert ties[4:7].any()  # coarse before new on an exact tie
    if not keyed:
        assert (order == rorder).all(-1).float().mean() >= 0.98


def test_importance_resample_rejects_what_it_cannot_take(dev):
    """Fewer than 3 coarse or 1 new samples, or more merged samples than a
    block's shared memory holds, raise and launch nothing."""
    kernels.reset_launches()
    for s1, s2 in ((2, 4), (8, 0), (8, pl.RESAMPLE_MAX_MERGED)):
        z = torch.sort(torch.rand((4, s1), device=dev)).values
        with pytest.raises(ValueError, match="importance_resample"):
            pl.importance_resample(z, torch.ones_like(z), s2)
    assert kernels.LAUNCHES["importance_resample"] == 0


def test_importance_resample_at_its_largest_shape(dev):
    """S1 + S2 = RESAMPLE_MAX_MERGED: four rays a block fill the default
    48 KB of shared memory exactly."""
    s1 = s2 = pl.RESAMPLE_MAX_MERGED // 2
    z, sigma = _resample_inputs(64, s1, seed=9)
    z, sigma = z.to(dev), sigma.to(dev)
    nz, zs, order = pl.importance_resample(z, sigma, s2)
    rnz = pl.importance_resample_plain(z, sigma, s2)[0]
    _new_z_within_reach(nz, z, sigma, pl.det_u(s2, dev), rnz)
    assert torch.equal(order, torch.sort(torch.cat([z, nz], -1), dim=-1,
                                         stable=True).indices)


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


def _spec_table(dev, n_features=4, seed=0):
    spec = he.make_spec(8, n_features, 15, 16, he.ngp_per_level_scale(1.0, 8))
    g = torch.Generator().manual_seed(seed)
    table = torch.rand((spec.table_size, n_features), generator=g) * 2 - 1
    x01 = torch.rand((20011, 3), generator=g)
    return spec, table.to(dev).to(torch.bfloat16), x01.to(dev), g


@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_sampled_matches_plain(dev, n_features):
    """Bit-equal: the same corner draw, then a copy of one bf16 row."""
    spec, tb, x01, _ = _spec_table(dev, n_features)
    torch.testing.assert_close(he.hash_encode_sampled(tb, x01, spec),
                               he.hash_encode_sampled_plain(tb, x01, spec),
                               rtol=0, atol=0)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_bwd_matches_plain(dev, stochastic, n_features):
    """The same contributions summed in another order (f32 atomics against
    index_add_): each entry within 1e-5 of the |contributions| on it."""
    spec, _, x01, g = _spec_table(dev, n_features)
    cot = torch.randn((x01.shape[0], spec.out_dim), generator=g).to(dev)
    cot = cot.to(torch.bfloat16)
    out = he.hash_encode_bwd(x01, cot, spec, stochastic)
    ref = he.hash_encode_bwd_plain(x01, cot, spec, stochastic)
    mass = he.hash_encode_bwd_plain(x01, cot.abs(), spec, stochastic)
    assert ((out - ref).abs() <= 1e-5 * mass).all()
    assert (ref != 0).sum() > 1000


def _crowded_points(n, seed):
    """n points, the first half in a 0.02-wide box (a few cells of the dense
    levels, where a warp's lanes share rows), the rest uniform."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=g)
    x[: n // 2] = 0.41 + 0.02 * x[: n // 2]
    return x, g


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_bwd_crowded_points(dev, n_features, stochastic):
    """Points crowded into a few cells, so that a warp's lanes share rows on
    the dense levels and add them up before the reduction, N not a multiple
    of 32: every entry within 1e-5 of the |contributions| on it (f32
    reductions in another order than index_add_)."""
    spec = he.make_spec(8, n_features, 15, 16, he.ngp_per_level_scale(1.0, 8))
    assert not all(spec.hashed) and any(spec.hashed)
    x01, g = _crowded_points(20011, seed=n_features)
    cot = torch.randn((x01.shape[0], spec.out_dim), generator=g)
    x01, cot = x01.to(dev), cot.to(dev).to(torch.bfloat16)
    out = he.hash_encode_bwd(x01, cot, spec, stochastic)
    ref = he.hash_encode_bwd_plain(x01, cot, spec, stochastic)
    mass = he.hash_encode_bwd_plain(x01, cot.abs(), spec, stochastic)
    assert ((out - ref).abs() <= 1e-5 * mass).all()
    assert (ref != 0).sum() > 1000


@pytest.mark.parametrize("t", [32, 64, 512, 1024])
def test_composite_bwd_matches_plain(dev, t):
    """The division-free backward against autograd of the plain forward,
    with vacuum rays and σ = 1e30, at the step's 32 samples up to
    composite_fwd's limit of 1024 (the trainer's default 256 + 256 is 512):
    rtol 1e-3 with an atol of 1e-4 of the ray's largest |d sigma| short of
    its last sample (whose δ = 1e10 can make it dwarf the others), 1e-5 on
    d rgb and d sem (the same weights times the cotangent)."""
    g = torch.Generator().manual_seed(5)
    n, c = 1000, 40
    z = torch.sort(torch.rand((n, t), generator=g) * 3 + 0.2).values
    sigma = torch.exp(torch.randn((n, t), generator=g) * 2)
    sigma[:4] = 0.0
    sigma[4:8] = 1e30
    rgb = torch.rand((n, t, 3), generator=g)
    sem = torch.softmax(torch.randn((n, t, c), generator=g), -1)
    dn = 1 + torch.rand((n,), generator=g)
    cots = [torch.randn(shape, generator=g) for shape in ((n, 3), (n, c),
                                                           (n,))]
    args = [a.to(dev) for a in (z, sigma, rgb, sem, dn, *cots)]
    out = cp.composite_bwd(*args)
    ref = cp.composite_bwd_plain(*args)
    for a in out:
        assert torch.isfinite(a).all()
    scale = ref[0][:, :-1].abs().amax(-1, keepdim=True)
    assert ((out[0] - ref[0]).abs() <= 1e-3 * ref[0].abs()
            + 1e-4 * scale).all()
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_composite_bwd_rejects_more_than_1024_samples(dev):
    """1025 samples raise, as composite_fwd does, and launch nothing."""
    n, t, c = 4, 1025, 3
    z = torch.sort(torch.rand((n, t), device=dev)).values
    ones = [torch.ones(shape, device=dev) for shape in ((n, t), (n, t, 3),
                                                        (n, t, c), (n,),
                                                        (n, 3), (n, c), (n,))]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="1024"):
        cp.composite_bwd(z, *ones)
    assert kernels.LAUNCHES["composite_bwd"] == 0


def test_occ_grid_update_matches_plain(dev):
    """Exact: one multiply and one max per cell, in both."""
    g = torch.Generator().manual_seed(6)
    grid = (torch.rand((128,) * 3, generator=g) * 3).to(dev)
    sig = (torch.rand((128 ** 3 // 4,), generator=g) * 3).to(dev)
    for slab in range(4):
        off = slab * sig.shape[0]
        torch.testing.assert_close(oc.occ_grid_update(grid, sig, off, 0.62),
                                   oc.occ_grid_update_plain(grid, sig, off,
                                                            0.62),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("proposal", [False, True])
def test_occ_placement_random_u_matches_plain(dev, proposal):
    """Per-ray uniforms (sorted in the kernel): z as the plain version's
    sorted z, tolerances as for det u."""
    o, d = _rays(1000, dev)
    u = torch.rand((1000, 24), generator=torch.Generator().manual_seed(7))
    args = (o, d, _grid(32, dev), 1.0, 24, 128, 0.2, proposal, 0.01, 0.01,
            1.0, u.to(dev))
    z = pl.occ_placement(*args)
    ref = pl.occ_placement_plain(*args)
    assert (z[:, 1:] >= z[:, :-1]).all()
    torch.testing.assert_close(z, ref, rtol=1e-5, atol=1e-3)
    assert (z - ref).abs().mean() < 1e-5


def _placement_close(z, ref):
    """Sorted, finite and within the tolerances above of the plain
    version's sorted z (atol 1e-3, mean 1e-5: the warp scans sum the pdf
    in another order than torch's sum and cumsum)."""
    assert torch.isfinite(z).all()
    assert (z[:, 1:] >= z[:, :-1]).all()
    torch.testing.assert_close(z, ref, rtol=1e-5, atol=1e-3)
    assert (z - ref).abs().mean() < 1e-5


@pytest.mark.parametrize("keyed", [False, True], ids=["det", "random_u"])
@pytest.mark.parametrize("s", [1, 8, 33, 256])
@pytest.mark.parametrize("n_cand", [3, 37, 128, 256])
def test_occ_placement_shapes(dev, n_cand, s, keyed):
    """A warp per ray at candidate and sample counts below, across and
    above its 32 lanes, in both placement modes."""
    o, d = _rays(1000, dev, seed=n_cand + s)
    u = torch.rand((1000, s), generator=torch.Generator().manual_seed(s))
    u = u.to(dev) if keyed else None
    for proposal in (False, True):
        args = (o, d, _grid(32, dev), 1.0, s, n_cand, 0.2, proposal, 0.01,
                0.01, 1.0, u)
        _placement_close(pl.occ_placement(*args),
                         pl.occ_placement_plain(*args))


def test_occ_placement_u_with_ties_and_descending(dev):
    """Per-ray u where every value comes twice, rows in descending order and
    rows of one value: the rank sort keeps the row sorted."""
    o, d = _rays(1000, dev, seed=5)
    g = torch.Generator().manual_seed(9)
    u = torch.rand((1000, 20), generator=g).repeat(1, 2)
    u[:500] = torch.sort(u[:500], -1, descending=True).values
    u[500:600] = 0.5
    for proposal in (False, True):
        args = (o, d, _grid(32, dev), 1.0, 40, 128, 0.2, proposal, 0.01,
                0.01, 1.0, u.to(dev))
        z = pl.occ_placement(*args)
        _placement_close(z, pl.occ_placement_plain(*args))
        assert (z[:, 1::2] == z[:, ::2]).all()  # each z twice, side by side


@pytest.mark.parametrize("keyed", [False, True], ids=["det", "random_u"])
def test_occ_placement_rays_that_miss(dev, keyed):
    """Every ray misses the box: near = far = 1e10, every z the sentinel,
    exactly as the plain version's."""
    g = torch.Generator().manual_seed(6)
    o = torch.rand((1000, 3), generator=g) * 2 - 1
    o[:, :2] += 3.0  # x, y in [2, 4]: the lines along z pass by the box
    d = torch.zeros((1000, 3))
    d[:, 2] = torch.where(torch.rand(1000, generator=g) < 0.5, -1.0, 1.0)
    o, d = o.to(dev), d.to(dev)
    u = torch.rand((1000, 24), device=dev) if keyed else None
    for proposal in (False, True):
        args = (o, d, _grid(32, dev), 1.0, 24, 128, 0.2, proposal, 0.01,
                0.01, 1.0, u)
        z = pl.occ_placement(*args)
        assert (z == 1e10).all()
        torch.testing.assert_close(z, pl.occ_placement_plain(*args), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("keyed", [False, True], ids=["det", "random_u"])
def test_occ_placement_all_floor_grid(dev, keyed):
    """A grid below the threshold everywhere: every weight the floor, a
    uniform pdf."""
    o, d = _rays(1000, dev, seed=7)
    grid = torch.full((32, 32, 32), 1e-3, device=dev)
    u = torch.rand((1000, 24), device=dev) if keyed else None
    for proposal in (False, True):
        args = (o, d, grid, 1.0, 24, 128, 0.2, proposal, 0.01, 0.01, 1.0, u)
        _placement_close(pl.occ_placement(*args),
                         pl.occ_placement_plain(*args))


def test_occ_placement_rejects_what_it_cannot_take(dev):
    """Fewer than 3 candidates or 1 sample, or more than a ray's share of
    the block's shared memory (n_cand - 1 + 2·S words), raise and launch
    nothing; the largest shape that fits runs."""
    o, d = _rays(64, dev)
    grid = _grid(8, dev)
    big = (pl.PLACEMENT_MAX_WORDS - 127) // 2
    kernels.reset_launches()
    for n_cand, s in ((2, 8), (16, 0), (128, big + 1)):
        with pytest.raises(ValueError, match="occ_placement"):
            pl.occ_placement(o, d, grid, 1.0, s, n_cand)
    assert kernels.LAUNCHES["occ_placement"] == 0
    u = torch.rand((64, big), device=dev)
    for uu in (None, u):
        args = (o, d, grid, 1.0, big, 128, 0.2, False, 0.01, 0.01, 1.0, uu)
        _placement_close(pl.occ_placement(*args),
                         pl.occ_placement_plain(*args))


def test_importance_resample_random_u_matches_plain(dev):
    """Per-ray uniforms: the kernel's new z are the plain version's as a
    set (sorted), the merged z agree, and the order gathers the merged z."""
    g = torch.Generator().manual_seed(8)
    z = torch.sort(torch.rand((1000, 24), generator=g) * 3 + 0.2).values
    sigma = torch.exp(torch.randn((1000, 24), generator=g) * 2)
    u = torch.rand((1000, 8), generator=g)
    z, sigma, u = z.to(dev), sigma.to(dev), u.to(dev)
    nz, zs, order = pl.importance_resample(z, sigma, 8, 1.0, u)
    rnz, rzs, _ = pl.importance_resample_plain(z, sigma, 8, 1.0, u)
    assert (nz[:, 1:] >= nz[:, :-1]).all()
    torch.testing.assert_close(nz, torch.sort(rnz, -1).values, rtol=1e-5,
                               atol=1e-3)
    torch.testing.assert_close(zs, rzs, rtol=1e-5, atol=1e-3)
    assert torch.equal(torch.take_along_dim(torch.cat([z, nz], -1), order,
                                            -1), zs)


def test_train_step_goes_through_every_kernel(dev):
    """Two training steps and a refresh launch all ten kernels of the
    training path (every kernel but the gather benchmark's); the same
    from the same state inside plain_versions() launches none, and the
    first step's losses agree (rtol 2e-3)."""
    g = torch.Generator().manual_seed(2)
    pose = torch.eye(4)
    pose[2, 3] = -0.7
    batch = {k: v.to(dev) for k, v in {
        "pose": pose, "intrinsics": torch.tensor([30.0, 30.0, 16.0, 12.0]),
        "image": torch.rand((24, 32, 3), generator=g),
        "label": torch.randint(-1, 6, (24, 32), generator=g),
        "depth": torch.rand((24, 32), generator=g),
        "one_m_to_scene_uom": torch.tensor(1.0)}.items()}

    def run():
        model = SemanticNeRF(bound=1.0, num_semantic_classes=6, n_levels=8,
                             n_features=4, log2_hashmap_size=15, device=dev,
                             generator=torch.Generator().manual_seed(0))
        tr = NeRFTrainer(model, RenderConfig(num_steps=24, upsample_steps=8,
                                             proposal_placement=True),
                         n_rays=512, image_hw=(24, 32), device=dev)
        tr.occ_cfg = oc.OccupancyConfig(resolution=32)
        gen = torch.Generator(dev).manual_seed(1)
        grid = tr.init_occupancy()
        losses = [tr.train_step(batch, gen, grid)]
        grid = tr.update_occupancy(grid, gen)
        losses.append(tr.train_step(batch, gen, grid))
        return losses

    kernels.reset_launches()
    out = run()
    assert all(v > 0 for k, v in kernels.LAUNCHES.items()
               if k != "dma_gather"), kernels.LAUNCHES
    kernels.reset_launches()
    with kernels.plain_versions():
        ref = run()
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    for k, v in out[0].items():
        assert torch.isfinite(v) and torch.isfinite(out[1][k])
        torch.testing.assert_close(v, ref[0][k], rtol=2e-3, atol=0)


def test_render_goes_through_every_kernel(dev):
    """A small staged early-stop render launches the five forward kernels
    and agrees with the plain path on the card."""
    model = SemanticNeRF(bound=1.0, num_semantic_classes=6, n_levels=8,
                         n_features=4, log2_hashmap_size=15, device=dev)
    o, d = _rays(1000, dev, seed=4)
    dn = torch.ones(1000, device=dev)
    cfg = RenderConfig(num_steps=16, upsample_steps=16, early_stop=True,
                       stage1_steps=8, max_ray_batch=256)
    grid = _grid(32, dev)
    kernels.reset_launches()
    out = render_rays_staged(model, o, d, dn, cfg, grid)
    render_kernels = ("hash_encode_fwd", "occ_placement",
                      "importance_resample", "composite_fwd", "mlp_fwd")
    assert all(kernels.LAUNCHES[k] > 0 for k in render_kernels), \
        kernels.LAUNCHES
    kernels.reset_launches()
    with kernels.plain_versions():
        ref = render_rays_staged(model, o, d, dn, cfg, grid)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    for k in out:
        assert torch.isfinite(out[k]).all()
        assert (out[k] - ref[k]).abs().mean() < 1e-3, k


# (input width, hidden layers, output width) of the sigma, color and
# semantics MLPs of the shipped model (C = 40)
MLP_SHAPES = ((32, 1, 16), (31, 2, 3), (15, 1, 40))


def _mlp(dev, d_in, n_hidden, d_out, n, seed):
    """lecun-scaled f32 weights, x [n, d_in] and a cotangent [n, d_out] in
    bf16."""
    g = torch.Generator().manual_seed(seed)
    dims = [d_in] + [64] * n_hidden + [d_out]
    ws = [(torch.randn((b, a), generator=g) / a ** 0.5).to(dev)
          for a, b in zip(dims[:-1], dims[1:])]
    x = torch.randn((n, d_in), generator=g).to(dev).to(torch.bfloat16)
    dy = torch.randn((n, d_out), generator=g).to(dev).to(torch.bfloat16)
    return ws, x, dy


def _rows_close(out, ref, min_equal=0.98):
    """Within two bf16 ulps of each row's largest |value| (tensor-core and
    cuBLAS sums in other orders round an element to the other neighbour
    now and then), and nearly all bit-equal."""
    out, ref = out.float(), ref.float()
    scale = ref.abs().amax(-1, keepdim=True)
    diff = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert (diff <= 2.0 ** -7 * scale).all(), (diff / scale).max().item()
    assert (diff == 0).float().mean() >= min_equal


MLP_FWD_N = [1, 15, 17, 1000, 65536 + 17]


@pytest.mark.parametrize("n", MLP_FWD_N)
@pytest.mark.parametrize("shape", MLP_SHAPES, ids=["sigma", "color",
                                                   "semantics"])
def test_mlp_fwd_matches_plain(dev, shape, n):
    """The fused forward against the torch.matmul chain, at ragged N (one
    tile short, one tile and a row, many tiles per warp and a ragged last
    one); the color MLP's 31-wide rows start 62 B apart."""
    ws, x, _ = _mlp(dev, *shape, n, seed=n)
    y = sn.mlp_fwd(x, ws)
    assert y.shape == (n, shape[2]) and y.dtype == torch.bfloat16
    _rows_close(y, sn.mlp_fwd_plain(x, ws))


def _dw_close(dws, rdws):
    """Each dW (f32 sums over N, one bf16 rounding) within an ulp of its
    magnitude plus 2^-12 of the layer's largest |value|."""
    for dw, ref in zip(dws, rdws):
        assert dw.shape == ref.shape and torch.isfinite(dw).all()
        tol = 2.0 ** -7 * ref.abs() + 2.0 ** -12 * ref.abs().max()
        assert ((dw - ref).abs() <= tol).all()


def _same_bits(a, b):
    """Two mlp_bwd results (dx, [dW]) bit for bit."""
    return torch.equal(a[0], b[0]) and all(map(torch.equal, a[1], b[1]))


@pytest.mark.parametrize("n", MLP_FWD_N + [131072 + 5])
@pytest.mark.parametrize("shape", MLP_SHAPES, ids=["sigma", "color",
                                                   "semantics"])
def test_mlp_bwd_matches_plain(dev, shape, n):
    """At ragged N (one block tile short, a warp's 16 rows and one more,
    many tiles per block and a ragged last one): dx of the first n of
    max(n, 4096) rows within two bf16 ulps of the row's scale and nearly
    all bit-equal (a statistic of many rows), and bit-equal to a call on n
    rows (a row's dx depends on its own inputs only); each dW within an ulp
    of its magnitude plus 2^-12 of the layer's largest |value|; the same
    bits on a second run (no atomics)."""
    ws, x, dy = _mlp(dev, *shape, max(n, 4096), seed=100 + n)
    dx_big = sn.mlp_bwd(x, ws, dy)[0]
    _rows_close(dx_big, sn.mlp_bwd_plain(x, ws, dy)[0])
    x, dy = x[:n], dy[:n]
    out = sn.mlp_bwd(x, ws, dy)
    assert out[0].shape == x.shape and out[0].dtype == torch.bfloat16
    assert torch.equal(out[0], dx_big[:n])
    _dw_close(out[1], sn.mlp_bwd_plain(x, ws, dy)[1])
    assert _same_bits(out, sn.mlp_bwd(x, ws, dy))


@pytest.mark.parametrize("shape", [(15, 1, 6), (64, 2, 64), (3, 0, 1)],
                         ids=["semantics_c6", "widest", "one_layer"])
def test_mlp_bwd_other_widths(dev, shape):
    """Widths other than the shipped model's three MLPs take the kernel
    compiled for widths read at run time: a 6-class semantics MLP, every
    layer 64 wide (past 48 KB of shared memory a block) and a single
    layer; the same bits twice."""
    ws, x, dy = _mlp(dev, *shape, 4096 + 17, seed=sum(shape))
    out = sn.mlp_bwd(x, ws, dy)
    rdx, rdws = sn.mlp_bwd_plain(x, ws, dy)
    _rows_close(out[0], rdx)
    _dw_close(out[1], rdws)
    assert _same_bits(out, sn.mlp_bwd(x, ws, dy))


@pytest.mark.parametrize("n", MLP_FWD_N)
def test_mlp_bwd_slices_and_misaligned_rows(dev, n):
    """Inputs whose rows do not start on 16 bytes, as the forward's test:
    the semantics MLP's 15-of-16 column slice (2 B into each 32 B row) and
    31-wide color rows from a data pointer only 2-byte aligned give the
    same dx and dW bits as an aligned contiguous copy (which
    test_mlp_bwd_matches_plain holds to the plain version)."""
    g = torch.Generator().manual_seed(n)
    ws, _, dy = _mlp(dev, 15, 1, 40, n, seed=n)
    h = torch.randn((n, 16), generator=g).to(dev).to(torch.bfloat16)
    x = h[:, 1:]
    assert x.data_ptr() % 16 == 2
    out = sn.mlp_bwd(x, ws, dy)
    assert _same_bits(out, sn.mlp_bwd(x.contiguous(), ws, dy))
    ws, x, dy = _mlp(dev, 31, 2, 3, n, seed=n + 1)
    buf = torch.empty(n * 31 + 1, dtype=torch.bfloat16, device=dev)
    xm = buf[1:].view(n, 31)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 2
    assert _same_bits(sn.mlp_bwd(xm, ws, dy), sn.mlp_bwd(x, ws, dy))


def test_mlp_reads_a_column_slice_in_place(dev):
    """The semantics net reads the sigma output's geo features h[:, 1:]
    without a copy: the same results as from the contiguous copy."""
    ws, _, dy = _mlp(dev, 15, 1, 40, 5000, seed=7)
    h = torch.randn((5000, 16), device=dev).to(torch.bfloat16)
    x = h[:, 1:]
    torch.testing.assert_close(sn.mlp_fwd(x, ws),
                               sn.mlp_fwd(x.contiguous(), ws), rtol=0, atol=0)
    a, b = sn.mlp_bwd(x, ws, dy), sn.mlp_bwd(x.contiguous(), ws, dy)
    assert torch.equal(a[0], b[0]) and all(map(torch.equal, a[1], b[1]))


@pytest.mark.parametrize("shape", [(15, 1, 6), (64, 2, 64), (3, 0, 1)],
                         ids=["semantics_c6", "widest", "one_layer"])
def test_mlp_fwd_other_widths(dev, shape):
    """Widths other than the shipped model's three MLPs take the kernel
    compiled for widths read at run time: a 6-class semantics MLP, every
    layer 64 wide (past 48 KB of shared memory a block) and a single
    layer."""
    ws, x, _ = _mlp(dev, *shape, 4096 + 17, seed=sum(shape))
    _rows_close(sn.mlp_fwd(x, ws), sn.mlp_fwd_plain(x, ws))


@pytest.mark.parametrize("n", MLP_FWD_N)
def test_mlp_fwd_slices_and_misaligned_rows(dev, n):
    """Inputs whose rows do not start on 16 bytes: the semantics MLP's
    15-of-16 column slice (2 B into each 32 B row) and 31-wide color rows
    from a data pointer only 2-byte aligned. The first n rows give the same
    bits as an aligned contiguous copy of them and as the first n rows of
    a call on max(n, 4096) rows (a row's outputs depend on its own inputs
    only), which is held to the plain version (the share of bit-equal
    elements is a statistic of many rows)."""
    big = max(n, 4096)
    g = torch.Generator().manual_seed(n)
    ws, _, _ = _mlp(dev, 15, 1, 40, 1, seed=n)
    h = torch.randn((big, 16), generator=g).to(dev).to(torch.bfloat16)
    x = h[:, 1:]
    assert x.data_ptr() % 16 == 2
    y = sn.mlp_fwd(x, ws)
    _rows_close(y, sn.mlp_fwd_plain(x, ws))
    y_n = sn.mlp_fwd(x[:n], ws)
    assert torch.equal(y_n, y[:n])
    assert torch.equal(y_n, sn.mlp_fwd(x[:n].contiguous(), ws))
    ws, x, _ = _mlp(dev, 31, 2, 3, big, seed=n + 1)
    buf = torch.empty(big * 31 + 1, dtype=torch.bfloat16, device=dev)
    xm = buf[1:].view(big, 31)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 2
    y = sn.mlp_fwd(xm, ws)
    _rows_close(y, sn.mlp_fwd_plain(xm, ws))
    y_n = sn.mlp_fwd(xm[:n], ws)
    assert torch.equal(y_n, y[:n])
    assert torch.equal(y_n, sn.mlp_fwd(x[:n], ws))


@pytest.mark.parametrize("f,dtype", [(2, torch.bfloat16), (8, torch.bfloat16),
                                     (16, torch.float32),
                                     (128, torch.bfloat16)])
def test_dma_gather_matches_index_select(dev, f, dtype):
    """Bit-equal (a copy), at the script's row widths (4, 16, 64 and 256
    bytes), with a ragged number of indices."""
    table, idx = bg.gather_inputs(1 << 12, 100003, f, dtype, dev)
    kernels.reset_launches()
    out = bg.dma_gather(table, idx)
    assert kernels.LAUNCHES["dma_gather"] == 1
    assert torch.equal(out, bg.dma_gather_plain(table, idx))


def test_dma_gather_rejects_other_row_widths(dev):
    """Rows that are not a power of two of at least 4 bytes raise, and
    launch nothing."""
    kernels.reset_launches()
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    for f in (1, 3):
        with pytest.raises(ValueError, match="dma_gather"):
            bg.dma_gather(torch.zeros((16, f), dtype=torch.bfloat16,
                                      device=dev), idx)
    assert kernels.LAUNCHES["dma_gather"] == 0
