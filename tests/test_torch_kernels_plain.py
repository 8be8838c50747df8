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
    test_sample_pdf_det_matches_jax for why a cdf's last bits move z more.
"""

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
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as the
from ucsa_neural_rendering_tpu_torch.ops import aabb as taabb
from ucsa_neural_rendering_tpu_torch.ops import compositing as tcomp
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import placement as tplace
from ucsa_neural_rendering_tpu_torch.ops import sampling as tsamp

F32_TOL = dict(rtol=1e-6, atol=1e-5)


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


@pytest.mark.parametrize("degenerate", [False, True])
def test_composite_matches_jax(degenerate):
    """composite(composite_weights(...)), also through the composite_fwd
    wrapper's CPU route; degenerate = the all-miss batch (every z at the
    1e10 sentinel), which must stay finite."""
    z, sigma, rgb, sem, dn = _composite_inputs(np.random.default_rng(7))
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


@pytest.mark.parametrize("proposal", [False, True])
def test_occ_placement_plain_matches_jax(proposal):
    """The occ_placement wrapper's CPU route against the JAX renderer's
    coarse placement (ops/renderer.py:262-296) composed from its parts."""
    rng = np.random.default_rng(8)
    bound, r, n_cand, s = 1.0, 16, 128, 16
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
