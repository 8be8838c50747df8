"""The port's plain PyTorch versions against their JAX counterparts, on the
CPU, at small sizes. The same numpy-seeded inputs go through both.

These plain versions are what every CUDA kernel of the port is held to on
the card (chip_smoke.py), so agreement here carries over to the kernels.
The JAX side runs under jax.jit, as the JAX package's render entry points
do (XLA's fused bf16 arithmetic differs from op-by-op execution).

Tolerances:
  * hash encode (bf16 output): |torch - jax| <= 1 bf16 ulp of the element's
    magnitude (|ref| * 2^-7); the two sides blend the same f32 products and
    may differ only in f32 summation order before the one bf16 rounding.
  * f32 geometry, stratified samples and compositing: rtol 1e-6 or atol
    1e-5, where sums and products of a different order can differ in the
    last bits; grid lookups and the AABB sentinel are exact.
  * inverse-CDF placement (sample_pdf, occ_placement, importance_resample):
    rtol 1e-6 / atol 1e-4 with a mean below 1e-6, see
    test_sample_pdf_det_matches_jax for why a cdf's last bits move z more;
    the keyed draws take JAX's own uniforms.
  * sampled corners (_corner_uniform, sampled_corner_indices,
    hash_encode_sampled): bit-equal.
  * table gradients (f32 scatter of bf16 cotangents): per element within
    1e-6 of the sum of the |contributions| landing on it (f32 sums in
    another order).
  * compositing VJP: rtol 1e-5, with an atol of 1e-5 of each output's
    largest |value| (sums and products of another order; the cumprod's
    gradient is a scan in JAX and a division in torch's autograd).
  * row gather: bit-equal (a copy).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu.models import hash_encoding as jhe
from ucsa_neural_rendering_tpu.ops import aabb as jaabb
from ucsa_neural_rendering_tpu.ops import compositing as jcomp
from ucsa_neural_rendering_tpu.ops import occupancy as jocc
from ucsa_neural_rendering_tpu.ops import sampling as jsamp
from ucsa_neural_rendering_tpu_torch.bench import dma_gather as tgather
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as the
from ucsa_neural_rendering_tpu_torch.ops import aabb as taabb
from ucsa_neural_rendering_tpu_torch.ops import compositing as tcomp
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import placement as tplace
from ucsa_neural_rendering_tpu_torch.ops import sampling as tsamp

F32_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_exp():
    """The first torch.exp that a process splits over its CPU threads can
    return values ~1e-5 off (relative) in the chunks of threads that had not
    run it before (seen with torch 2.13 on the CPU, now and then, and never
    on a later call): one call over all the threads first keeps the
    comparisons with JAX, e.g. the proposal placement's alphas,
    deterministic."""
    torch.exp(torch.zeros(1 << 20))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(rng, n, bound=1.0):
    """Origins inside and outside the box, unit directions, some with exact
    zero components (the eps-inverse branch) and some that miss."""
    o = rng.uniform(-2.5 * bound, 2.5 * bound, (n, 3)).astype(np.float32)
    o[: n // 2] *= 0.3  # half start inside the box
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, 0] = 0.0
    d[::11] = [0.0, 0.0, -1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("n_levels,n_features,log2", [(8, 4, 15), (16, 2, 15),
                                                      (4, 8, 12)])
@pytest.mark.parametrize("bound", [1.0, 4.0])
def test_make_spec_matches_jax(n_levels, n_features, log2, bound):
    scale_j = jhe.ngp_per_level_scale(bound, n_levels)
    scale_t = the.ngp_per_level_scale(bound, n_levels)
    assert scale_j == scale_t
    sj = jhe.make_spec(n_levels, n_features, log2, 16, scale_j)
    st = the.make_spec(n_levels, n_features, log2, 16, scale_t)
    assert (sj.resolutions, sj.offsets, sj.sizes, sj.hashed) == \
        (st.resolutions, st.offsets, st.sizes, st.hashed)
    assert sj.table_size == st.table_size and sj.out_dim == st.out_dim


@pytest.mark.parametrize("lvl", range(8))
def test_level_indices_match_jax(lvl):
    """Corner indices exact (uint32 hash in masked int64) and trilinear
    weights exact, per level of the 8×4, 2^15 geometry (levels 0 dense,
    1-7 hashed)."""
    spec = the.make_spec(8, 4, 15, 16, the.ngp_per_level_scale(1.0, 8))
    rng = np.random.default_rng(lvl)
    x = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1], [0.5, 0.5, 0.5],
             [1e-7, 1 - 1e-7, 0.25], [0.999, 0.001, 1], [0.3, 0.7, 0.0]]
    args = (spec.resolutions[lvl], spec.sizes[lvl], spec.hashed[lvl])
    ji, jw = jax.jit(lambda x: jhe._level_indices(x, *args))(x)
    ti, tw = the._level_indices(_t(x), *args)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    assert ti.min() >= 0 and ti.max() < spec.sizes[lvl]


@pytest.mark.parametrize("n_levels,n_features", [(8, 4), (16, 2)])
def test_hash_encode_matches_jax(n_levels, n_features):
    """hash_encode at log2 15 (dense and hashed levels), bf16: within one
    bf16 ulp of each element's magnitude, and nearly all bit-equal."""
    spec = the.make_spec(n_levels, n_features, 15, 16,
                         the.ngp_per_level_scale(1.0, n_levels))
    jspec = jhe.make_spec(n_levels, n_features, 15, 16,
                          jhe.ngp_per_level_scale(1.0, n_levels))
    assert not all(spec.hashed) and any(spec.hashed)
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (spec.table_size, n_features)
                        ).astype(np.float32)
    x = rng.uniform(0, 1, (20000, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0]]
    ref = np.asarray(jax.jit(lambda t, x: jhe.hash_encode(t, x, jspec))(
        table, x).astype(jnp.float32))
    tb = _t(table).to(torch.bfloat16)
    out = the.hash_encode(tb, _t(x), spec)
    assert out.dtype == torch.bfloat16 and out.shape == (20000, spec.out_dim)
    out = out.float().numpy()
    diff = np.abs(out - ref)
    assert (diff <= np.abs(ref) * 2.0 ** -7).all(), diff.max()
    assert (diff == 0).mean() > 0.9999


def test_hash_encoding_module_caches_bf16_copy():
    spec = the.make_spec(4, 2, 12, 16, the.ngp_per_level_scale(1.0, 4))
    enc = the.HashGridEncoding(spec, "cpu", torch.Generator().manual_seed(0))
    first = enc.table_bf16()
    assert enc.table_bf16() is first
    with torch.no_grad():
        enc.table.add_(1.0)
    second = enc.table_bf16()
    assert second is not first
    torch.testing.assert_close(second, enc.table.detach().to(torch.bfloat16))


@pytest.mark.parametrize("bound", [1.0, 4.0])
def test_near_far_from_aabb_matches_jax(bound):
    rng = np.random.default_rng(2)
    o, d = _rays(rng, 512, bound)
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    jn, jf = jax.jit(jaabb.near_far_from_aabb)(o, d, aabb)
    tn, tf = taabb.near_far_from_aabb(_t(o), _t(d), _t(aabb))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **F32_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **F32_TOL)
    miss = np.asarray(jn) == jaabb.MISS_SENTINEL
    assert miss.any() and (~miss).any()
    np.testing.assert_array_equal(tn.numpy() == taabb.MISS_SENTINEL, miss)
    np.testing.assert_array_equal(tf.numpy()[miss], np.float32(1e10))


@pytest.mark.parametrize("num", [1, 2, 8, 16, 32, 128])
def test_linspace_matches_jnp(num):
    """The candidate positions linspace(0, 1) are bit-equal; the det
    inverse-CDF positions linspace(0.5/S, 1-0.5/S) are within 1e-6
    relative (XLA's own eager and jitted results differ there by an ulp or
    two)."""
    ref = np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32))
    np.testing.assert_array_equal(tsamp.linspace(0.0, 1.0, num, "cpu")
                                  .numpy(), ref)
    ref = np.asarray(jax.jit(lambda: jnp.linspace(
        0.5 / num, 1.0 - 0.5 / num, num, dtype=jnp.float32))())
    np.testing.assert_allclose(tsamp.det_u(num, "cpu").numpy(), ref,
                               rtol=1e-6, atol=0)


def test_stratified_samples_matches_jax():
    rng = np.random.default_rng(3)
    nears = rng.uniform(0.2, 2, 64).astype(np.float32)
    fars = (nears + rng.uniform(0, 3, 64)).astype(np.float32)
    fars[:4] = nears[:4]  # zero-extent intervals
    ref = jax.jit(lambda n, f: jsamp.stratified_samples(n, f, 32, None))(
        nears, fars)
    out = tsamp.stratified_samples(_t(nears), _t(fars), 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("n_samples", [8, 16, 32])
def test_sample_pdf_det_matches_jax(n_samples):
    """Tolerance rtol 1e-6, atol 1e-4 on z in [0.2, 4], and mean |diff|
    below 1e-6. An inverse CDF maps a cdf error δ to a z error
    δ·width/pdf: XLA's f32 cumsum and torch's sequential one differ by
    ~1e-7, which a narrow-pdf bin lifts to ~1e-5..1e-4 (torch's side is the
    closer of the two to a float64 evaluation, checked below)."""
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(0.2, 4, (64, 33)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (64, 32)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.4] = 0.0
    w[:2] = 0.0  # all-floor rows
    ref = np.asarray(jax.jit(
        lambda b, w: jsamp.sample_pdf(b, w, n_samples, None))(bins, w))
    out = tsamp.sample_pdf(_t(bins), _t(w), n_samples).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    assert np.abs(out - ref).mean() < 1e-6
    w64 = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((64, 1)),
                          np.cumsum(w64 / w64.sum(-1, keepdims=True), -1)], -1)
    u = np.linspace(0.5 / n_samples, 1 - 0.5 / n_samples, n_samples)
    exact = np.stack([np.interp(u, c, b) for c, b in zip(cdf, bins)])
    assert np.abs(out - exact).max() <= np.abs(ref - exact).max() + 1e-6


def test_occupancy_and_density_at_match_jax():
    """Exact: the same cell for points inside, on the faces of and far
    outside the box (the 1e10 miss sentinel's candidates included)."""
    rng = np.random.default_rng(5)
    r, bound = 16, 1.0
    grid = np.where(rng.uniform(size=(r, r, r)) > 0.5,
                    rng.uniform(0, 5, (r, r, r)), 1e-3).astype(np.float32)
    xyz = rng.uniform(-1.3, 1.3, (2048, 3)).astype(np.float32)
    xyz[:6] = [[-1, -1, -1], [1, 1, 1], [1e10, -1e10, 0], [-1e10, 1e10, 1e10],
               [0.999999, -0.999999, 0], [0, 0, 0]]
    jd = jax.jit(lambda g, x: jocc.density_at(g, x, bound))(grid, xyz)
    td = tocc.density_at(_t(grid), _t(xyz), bound)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jo = jax.jit(lambda g, x: jocc.occupancy_at(g, x, bound, 0.01, 0.01))(
        grid, xyz)
    to = tocc.occupancy_at(_t(grid), _t(xyz), bound, 0.01, 0.01)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _composite_inputs(rng, n=64, t=24, c=6):
    z = np.sort(rng.uniform(0.2, 3, (n, t)), axis=-1).astype(np.float32)
    sigma = np.exp(rng.normal(0, 2, (n, t))).astype(np.float32)
    sigma[:3] = 0.0      # vacuum rays
    sigma[3:5] = 1e30    # saturating: delta·sigma overflows to -inf
    rgb = rng.uniform(0, 1, (n, t, 3)).astype(np.float32)
    sem = rng.dirichlet(np.ones(c), (n, t)).astype(np.float32)
    dn = rng.uniform(1, 1.5, n).astype(np.float32)
    return z, sigma, rgb, sem, dn


def test_composite_weights_matches_jax():
    z, sigma, _, _, _ = _composite_inputs(np.random.default_rng(6))
    ref = jax.jit(lambda z, s: jcomp.composite_weights(z, s, 1.0))(z, sigma)
    out = tcomp.composite_weights(_t(z), _t(sigma), 1.0)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


# (T, C): the CPU tests' 24 × 6, and the paths' T at the shipped 40
# classes (the render's stage 1 16 and refine 64, 33 past one warp's
# tile), which the card's kernels are held to through these plain versions
COMPOSITE_SHAPES = [(24, 6), (16, 40), (64, 40), (33, 40)]


@pytest.mark.parametrize("t,c", COMPOSITE_SHAPES)
@pytest.mark.parametrize("degenerate", [False, True])
def test_composite_matches_jax(degenerate, t, c):
    """composite(composite_weights(...)), also through the composite_fwd
    wrapper's CPU route; degenerate = the all-miss batch (every z at the
    1e10 sentinel), which must stay finite."""
    z, sigma, rgb, sem, dn = _composite_inputs(np.random.default_rng(7),
                                               t=t, c=c)
    if degenerate:
        z[:] = np.float32(1e10)
    ref = jax.jit(lambda z, s, rgb, sem, dn: jcomp.composite(
        jcomp.composite_weights(z, s, 1.0), z, rgb, sem, dn, 1e-4))(
        z, sigma, rgb, sem, dn)
    w = tcomp.composite_weights(_t(z), _t(sigma), 1.0)
    outs = [tcomp.composite(w, _t(z), _t(rgb), _t(sem), _t(dn), 1e-4),
            tcomp.composite_fwd(_t(z), _t(sigma), _t(rgb), _t(sem), _t(dn),
                                1.0, 1e-4)]
    for out in outs:
        for a, b in zip(out, ref):
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


# (candidates, samples) below, across and above a warp's 32 lanes: the
# occ_placement kernel, a warp per ray, is held to the plain version there
PLACEMENT_SHAPES = [(128, 16), (37, 40), (256, 64)]


@pytest.mark.parametrize("n_cand,s", PLACEMENT_SHAPES)
@pytest.mark.parametrize("proposal", [False, True])
def test_occ_placement_plain_matches_jax(proposal, n_cand, s):
    """The occ_placement wrapper's CPU route against the JAX renderer's
    coarse placement (ops/renderer.py:262-296) composed from its parts."""
    rng = np.random.default_rng(8)
    bound, r = 1.0, 16
    o, d = _rays(rng, 256, bound)
    grid = np.where(rng.uniform(size=(r, r, r)) > 0.6,
                    rng.uniform(0, 20, (r, r, r)), 1e-3).astype(np.float32)

    def jax_place(o, d, grid):
        aabb = jnp.array([-bound] * 3 + [bound] * 3, jnp.float32)
        nears, fars = jaabb.near_far_from_aabb(o, d, aabb, 0.2)
        cand_z = jsamp.stratified_samples(nears, fars, n_cand, None)
        xyz = o[:, None, :] + d[:, None, :] * cand_z[..., None]
        if proposal:
            sig = jocc.density_at(grid, xyz, bound)
            dz = ((fars - nears) / n_cand)[:, None]
            w = jnp.maximum(1.0 - jnp.exp(-sig * dz * 1.0), 0.01)
        else:
            w = jocc.occupancy_at(grid, xyz, bound, 0.01, 0.01)
        z_mid = 0.5 * (cand_z[..., 1:] + cand_z[..., :-1])
        return jnp.sort(jsamp.sample_pdf(z_mid, w[..., 1:-1], s, None), -1)

    ref = np.asarray(jax.jit(jax_place)(o, d, grid))
    out = tplace.occ_placement(_t(o), _t(d), _t(grid), bound, s, n_cand,
                               0.2, proposal, 0.01, 0.01, 1.0).numpy()
    assert (np.diff(out, axis=-1) >= 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    assert np.abs(out - ref).mean() < 1e-6


def test_importance_resample_plain_matches_jax():
    """The importance_resample wrapper's CPU route against the JAX fine pass
    (ops/renderer.py:305-325): new z, merged z and the stable order."""
    rng = np.random.default_rng(9)
    z, sigma, _, _, _ = _composite_inputs(rng, n=128, t=16)
    z[5:9] = np.float32(1e10)  # miss rays: every z ties
    z[9, 4:8] = z[9, 4]        # ties inside a ray

    def jax_fine(z, sigma):
        w = jcomp.composite_weights(z, sigma, 1.0)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        new_z = jsamp.sample_pdf(z_mid, w[:, 1:-1], 16, None)
        z_all = jnp.concatenate([z, new_z], -1)
        order = jnp.argsort(z_all, axis=-1)
        return new_z, jnp.take_along_axis(z_all, order, -1), order

    jn, jz, jo = (np.asarray(a) for a in jax.jit(jax_fine)(z, sigma))
    tn, tz, to = tplace.importance_resample(_t(z), _t(sigma), 16, 1.0)
    np.testing.assert_allclose(tn.numpy(), jn, **F32_TOL)
    np.testing.assert_allclose(tz.numpy(), jz, **F32_TOL)
    assert to.dtype == torch.int64
    # the order is a stable argsort: exact ties (miss rays, tied coarse z)
    # keep the lower index first; it equals JAX's on every ray whose merged
    # z have no near-tie that last-ulp differences could flip
    np.testing.assert_array_equal(to.numpy()[5:9],
                                  np.tile(np.arange(32), (4, 1)))
    gaps = np.diff(jz, axis=-1)
    clean = ((gaps == 0) | (gaps > 1e-4)).all(axis=-1)
    assert clean.mean() > 0.5 and clean[5:10].all()
    np.testing.assert_array_equal(to.numpy()[clean], jo[clean])
    z_all = np.concatenate([z, tn.numpy()], -1)
    np.testing.assert_array_equal(np.take_along_axis(z_all, to.numpy(), -1),
                                  tz.numpy())


@pytest.mark.parametrize("s1,s2", [(24, 8), (40, 33)])
def test_importance_resample_plain_matches_jax_at_ragged_shapes(s1, s2):
    """The plain fine pass (what the warp-per-ray kernel is held to on the
    card) against JAX where the samples are not a multiple of the warp:
    new z, merged z and, on rays without near-ties, the order; with miss
    rays, vacuum rays and coarse z that stop growing halfway (flat bins)."""
    rng = np.random.default_rng(s1 + s2)
    z, sigma, _, _, _ = _composite_inputs(rng, n=128, t=s1)
    z[5:9] = np.float32(1e10)
    z[9, s1 // 2:] = z[9, s1 // 2]

    def jax_fine(z, sigma):
        w = jcomp.composite_weights(z, sigma, 1.0)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        new_z = jsamp.sample_pdf(z_mid, w[:, 1:-1], s2, None)
        z_all = jnp.concatenate([z, new_z], -1)
        order = jnp.argsort(z_all, axis=-1)
        return new_z, jnp.take_along_axis(z_all, order, -1), order

    jn, jz, jo = (np.asarray(a) for a in jax.jit(jax_fine)(z, sigma))
    tn, tz, to = tplace.importance_resample_plain(_t(z), _t(sigma), s2, 1.0)
    assert tn.shape == (128, s2) and to.shape == (128, s1 + s2)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-6, atol=1e-4)
    assert np.abs(tz.numpy() - jz).mean() < 1e-6
    gaps = np.diff(jz, axis=-1)
    clean = ((gaps == 0) | (gaps > 1e-4)).all(axis=-1)
    assert clean.mean() > 0.5 and clean[5:10].all()
    np.testing.assert_array_equal(to.numpy()[clean], jo[clean])
    z_all = np.concatenate([z, tn.numpy()], -1)
    np.testing.assert_array_equal(np.take_along_axis(z_all, to.numpy(), -1),
                                  tz.numpy())


# --------------------------------------------------------------- training

def _spec_pair(n_levels=8, n_features=4, log2=15, bound=1.0):
    args = (n_levels, n_features, log2, 16)
    return (the.make_spec(*args, the.ngp_per_level_scale(bound, n_levels)),
            jhe.make_spec(*args, jhe.ngp_per_level_scale(bound, n_levels)))


def _x01(rng, n):
    """Points in [0, 1]³, with corners, faces and exact cell vertices."""
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0], [1e-7, 1 - 1e-7, 0.25],
             [0.25, 0.5, 0.75], [1 / 3, 2 / 3, 0.1]]
    return x


@pytest.mark.parametrize("n_levels,n_features", [(8, 4), (16, 2)])
def test_sampled_corners_bit_equal_to_jax(n_levels, n_features):
    """_corner_uniform and sampled_corner_indices (dense and hashed levels)
    bit-equal to JAX's uint32 hash and cumsum-cdf draw."""
    spec, jspec = _spec_pair(n_levels, n_features)
    x = _x01(np.random.default_rng(10), 8192)
    ju = np.asarray(jax.jit(lambda x: jhe._corner_uniform(x, n_levels))(x))
    np.testing.assert_array_equal(
        the._corner_uniform(_t(x), n_levels).numpy(), ju)
    ji = np.asarray(jax.jit(lambda x: jhe.sampled_corner_indices(x, jspec))(
        x))
    ti = the.sampled_corner_indices(_t(x), spec)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_hash_encode_sampled_matches_jax():
    """The probe's single-corner encode: a copy of one bf16 row, equal."""
    spec, jspec = _spec_pair()
    rng = np.random.default_rng(11)
    table = rng.uniform(-1, 1, (spec.table_size, 4)).astype(np.float32)
    x = _x01(rng, 4096)
    ref = np.asarray(jax.jit(lambda t, x: jhe.hash_encode_sampled(
        t, x, jspec))(table, x).astype(jnp.float32))
    out = the.hash_encode_sampled(_t(table).to(torch.bfloat16), _t(x), spec)
    assert out.dtype == torch.bfloat16 and out.shape == (4096, 32)
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("stochastic", [True, False])
def test_hash_encode_bwd_matches_jax_vjp(stochastic):
    """The table gradient against jax.vjp of hash_encode_stochastic_grad
    (one drawn corner) or hash_encode (8 weighted corners), on identical
    x01 and a seeded bf16 cotangent."""
    spec, jspec = _spec_pair()
    rng = np.random.default_rng(12)
    table = rng.uniform(-1, 1, (spec.table_size, 4)).astype(np.float32)
    x = _x01(rng, 4096)
    g = rng.normal(size=(4096, 32)).astype(np.float32)
    g_bf16 = jnp.asarray(g).astype(jnp.bfloat16)
    fn = jhe.hash_encode_stochastic_grad if stochastic else jhe.hash_encode

    @jax.jit
    def vjp(t, x, g):
        return jax.vjp(lambda t: fn(t, x, jspec), t)[1](g)[0]

    ref = np.asarray(vjp(table, x, g_bf16))
    g_t = torch.from_numpy(g).to(torch.bfloat16)
    out = the.hash_encode_bwd(_t(x), g_t, spec, stochastic)
    assert out.dtype == torch.float32 and out.shape == table.shape
    mass = the.hash_encode_bwd(_t(x), g_t.abs(), spec, stochastic).numpy()
    assert (np.abs(out.numpy() - ref) <= 1e-6 * mass + 1e-30).all()
    assert (ref != 0).sum() > 1000


def test_hash_encoding_module_gradient_goes_to_f32_table():
    """HashGridEncoding's autograd: the f32 table receives hash_encode_bwd
    of the bf16 cotangent, stochastic or exact as the module says; x01 gets
    none."""
    spec = the.make_spec(4, 2, 12, 16, the.ngp_per_level_scale(1.0, 4))
    rng = np.random.default_rng(13)
    x = _t(_x01(rng, 512))
    g = torch.from_numpy(rng.normal(size=(512, 8)).astype(np.float32)
                         ).to(torch.bfloat16)
    for stochastic in (True, False):
        enc = the.HashGridEncoding(spec, "cpu",
                                   torch.Generator().manual_seed(0),
                                   stochastic_grad=stochastic)
        out = enc(x)
        assert out.dtype == torch.bfloat16
        out.backward(g)
        torch.testing.assert_close(
            enc.table.grad, the.hash_encode_bwd(x, g, spec, stochastic),
            rtol=0, atol=0)
        torch.testing.assert_close(
            enc(x, probe=True),
            the.hash_encode_sampled(enc.table_bf16(), x, spec))


@pytest.mark.parametrize("n_samples", [8, 16])
def test_sample_pdf_keyed_matches_jax(n_samples):
    """sample_pdf with JAX's own uniforms injected, as its keyed branch
    draws them (jax.random.uniform(key, [N, S]))."""
    rng = np.random.default_rng(14)
    bins = np.sort(rng.uniform(0.2, 4, (64, 33)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (64, 32)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.4] = 0.0
    key = jax.random.key(3)
    ref = np.asarray(jax.jit(lambda b, w, k: jsamp.sample_pdf(
        b, w, n_samples, k))(bins, w, key))
    u = np.asarray(jax.random.uniform(key, (64, n_samples), jnp.float32))
    out = tsamp.sample_pdf(_t(bins), _t(w), n_samples, _t(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    assert np.abs(out - ref).mean() < 1e-6


def _compositing_vjp_inputs(rng, n=64, t=24, c=6):
    z, sigma, rgb, sem, dn = _composite_inputs(rng, n, t, c)
    # weights straddling the 1e-4 mask on some rays
    sigma[6:10] = np.float32(2e-4) / np.maximum(np.diff(
        z[6:10], axis=-1, append=z[6:10, -1:] + 1), 1e-3)
    g = [rng.normal(size=shape).astype(np.float32)
         for shape in ((n, 3), (n, c), (n,))]
    return z, sigma, rgb, sem, dn, g


@pytest.mark.parametrize("t,c", COMPOSITE_SHAPES)
def test_composite_vjp_matches_jax(t, c):
    """The composite's VJP (the plain version of composite_bwd) against
    jax.vjp of composite(composite_weights(...)): d sigma, d rgb, d sem,
    with vacuum rays, weights straddling the w > 1e-4 mask and σ = 1e30
    (every gradient finite); the semantics cotangent reaches no sigma."""
    z, sigma, rgb, sem, dn, g = _compositing_vjp_inputs(
        np.random.default_rng(15), t=t, c=c)

    @jax.jit
    def vjp(z, sigma, rgb, sem, dn, g):
        f = lambda s, r, m: jcomp.composite(
            jcomp.composite_weights(z, s, 1.0), z, r, m, dn, 1e-4)
        return jax.vjp(f, sigma, rgb, sem)[1](tuple(g))

    ref = [np.asarray(a) for a in vjp(z, sigma, rgb, sem, dn, g)]
    w = np.asarray(jcomp.composite_weights(z, sigma, 1.0))
    assert ((w > 0) & (w <= 1e-4)).sum() > 10 and (w > 1e-4).sum() > 100
    out = [a.numpy() for a in tcomp.composite_bwd(
        *(_t(a) for a in (z, sigma, rgb, sem, dn)), *(_t(a) for a in g),
        1.0, 1e-4)]
    for a, b in zip(out, ref):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    # only the semantics cotangent: no gradient reaches sigma
    g0 = [np.zeros_like(g[0]), g[1], np.zeros_like(g[2])]
    ds = tcomp.composite_bwd(*(_t(a) for a in (z, sigma, rgb, sem, dn)),
                             *(_t(a) for a in g0), 1.0, 1e-4)[0]
    assert not ds.any()


def test_composite_rays_autograd_is_composite_bwd():
    """composite_rays' backward hands autograd composite_bwd's gradients."""
    z, sigma, rgb, sem, dn, g = _compositing_vjp_inputs(
        np.random.default_rng(16))
    leaves = [_t(a).requires_grad_() for a in (sigma, rgb, sem)]
    outs = tcomp.composite_rays(_t(z), *leaves, _t(dn), 1.0, 1e-4)
    torch.autograd.backward(outs, [_t(a) for a in g])
    ref = tcomp.composite_bwd(_t(z), *(_t(a) for a in (sigma, rgb, sem)),
                              _t(dn), *(_t(a) for a in g), 1.0, 1e-4)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


@pytest.mark.parametrize("n_cand,s", [(128, 12)] + PLACEMENT_SHAPES)
@pytest.mark.parametrize("proposal", [False, True])
def test_occ_placement_keyed_matches_jax(proposal, n_cand, s):
    """Coarse placement with the per-ray uniforms of a training step (JAX:
    sample_pdf with k_coarse, then sort)."""
    rng = np.random.default_rng(17)
    bound, r = 1.0, 16
    o, d = _rays(rng, 256, bound)
    grid = np.where(rng.uniform(size=(r, r, r)) > 0.6,
                    rng.uniform(0, 20, (r, r, r)), 1e-3).astype(np.float32)
    key = jax.random.key(5)

    def jax_place(o, d, grid, key):
        aabb = jnp.array([-bound] * 3 + [bound] * 3, jnp.float32)
        nears, fars = jaabb.near_far_from_aabb(o, d, aabb, 0.2)
        cand_z = jsamp.stratified_samples(nears, fars, n_cand, None)
        xyz = o[:, None, :] + d[:, None, :] * cand_z[..., None]
        if proposal:
            sig = jocc.density_at(grid, xyz, bound)
            dz = ((fars - nears) / n_cand)[:, None]
            w = jnp.maximum(1.0 - jnp.exp(-sig * dz * 1.0), 0.01)
        else:
            w = jocc.occupancy_at(grid, xyz, bound, 0.01, 0.01)
        z_mid = 0.5 * (cand_z[..., 1:] + cand_z[..., :-1])
        return jnp.sort(jsamp.sample_pdf(z_mid, w[..., 1:-1], s, key), -1)

    ref = np.asarray(jax.jit(jax_place)(o, d, grid, key))
    u = _t(np.asarray(jax.random.uniform(key, (256, s), jnp.float32)))
    out = tplace.occ_placement(_t(o), _t(d), _t(grid), bound, s, n_cand,
                               0.2, proposal, 0.01, 0.01, 1.0, u).numpy()
    assert (np.diff(out, axis=-1) >= 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    assert np.abs(out - ref).mean() < 1e-6


def test_importance_resample_keyed_matches_jax():
    """The fine pass with a training step's per-ray uniforms (JAX:
    sample_pdf with k_fine, stable argsort merge)."""
    rng = np.random.default_rng(18)
    z, sigma, _, _, _ = _composite_inputs(rng, n=128, t=16)
    key = jax.random.key(6)

    def jax_fine(z, sigma, key):
        w = jcomp.composite_weights(z, sigma, 1.0)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        new_z = jsamp.sample_pdf(z_mid, w[:, 1:-1], 8, key)
        z_all = jnp.concatenate([z, new_z], -1)
        order = jnp.argsort(z_all, axis=-1)
        return new_z, jnp.take_along_axis(z_all, order, -1)

    jn, jz = (np.asarray(a) for a in jax.jit(jax_fine)(z, sigma, key))
    u = _t(np.asarray(jax.random.uniform(key, (128, 8), jnp.float32)))
    tn, tz, to = tplace.importance_resample(_t(z), _t(sigma), 8, 1.0, u)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-6, atol=1e-4)
    z_all = np.concatenate([z, tn.numpy()], -1)
    np.testing.assert_array_equal(np.take_along_axis(z_all, to.numpy(), -1),
                                  tz.numpy())


def test_occ_grid_update_matches_jax_formula():
    """The EMA step: the whole grid × decay, max with the densities on one
    slab's flat cells (ops/occupancy.py:99-105), exact."""
    rng = np.random.default_rng(19)
    r = 16
    grid = rng.uniform(0, 3, (r, r, r)).astype(np.float32)
    sig = rng.uniform(0, 3, r ** 3 // 4).astype(np.float32)
    off = 2 * sig.shape[0]

    @jax.jit
    def ema(grid, sig):
        flat = grid.reshape(-1) * 0.62
        cur = jax.lax.dynamic_slice(flat, (off,), (sig.shape[0],))
        return jax.lax.dynamic_update_slice(
            flat, jnp.maximum(cur, sig), (off,)).reshape(r, r, r)

    out = tocc.occ_grid_update(_t(grid), _t(sig), off, 0.62)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ema(grid, sig)))
    assert (out.numpy() != grid).any()  # a new grid; the input is untouched
    np.testing.assert_array_equal(grid, _t(grid).numpy())


# --------------------------------------------------------------- row gather

def _bench_dma_gather_script():
    """scripts/bench_dma_gather.py, loaded by path: a script, not a module
    of the JAX package."""
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "bench_dma_gather.py"
    spec = importlib.util.spec_from_file_location("bench_dma_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("f,dtype", [(2, "bfloat16"), (16, "float32")])
def test_dma_gather_plain_matches_pallas(f, dtype):
    """dma_gather's CPU route (torch.index_select) against the script's
    Pallas kernel make_dma_gather, run in TPU interpret mode on the CPU, on
    sorted int32 indices that include the table's first and last rows:
    bit-equal."""
    from jax.experimental.pallas import tpu as pltpu
    script = _bench_dma_gather_script()
    t, m, blk = 4096, 512, 256
    rng = np.random.default_rng(21)
    table = jnp.asarray(rng.normal(size=(t, f)), jnp.dtype(dtype))
    idx = np.sort(rng.integers(0, t, m).astype(np.int32))
    idx[0], idx[-1] = 0, t - 1
    with pltpu.force_tpu_interpret_mode():
        ref = script.make_dma_gather(t, f, m, jnp.dtype(dtype), blk=blk)(
            jnp.asarray(idx), table)
    ref = np.asarray(ref.astype(jnp.float32))
    tt = _t(np.array(table.astype(jnp.float32))).to(getattr(torch, dtype))
    out = tgather.dma_gather(tt, _t(idx))
    assert out.dtype == tt.dtype and out.shape == (m, f)
    np.testing.assert_array_equal(out.float().numpy(), ref)
