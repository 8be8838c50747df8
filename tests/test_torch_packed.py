"""K8, the cell-packed tables, and K9's packed and hybrid training encoders
against the JAX package on the CPU, at small sizes: choose_n_packed and
packed_offsets, the relayout (bf16 and fp8 rows), the three packed encodes,
HashGridEncoding's dispatch with and without a packed table, the packed
training encoders' table gradients, NeRFTrainer steps with train packing
(UCSA_TRAIN_PACKED_ON_CPU=1, the JAX package's own switch), render_rays
with a packed table and the cache's keying. The same numpy-seeded inputs go
through both sides; the JAX side runs jitted.

Tolerances:
  * packed rows: bit-equal, fp8's NaN for |x| > 464 and ±inf included;
  * the encodes: bit-equal on at least 0.999 of the elements, elsewhere
    within 2^-5 of the blend's Σ |product| (_assert_encode: jitted XLA
    rounds some fracs once, as an FMA, and sums 8 corners in another
    order);
  * table gradients, packed against unpacked: bit-equal (the same
    backward);
  * the training steps: as tests/test_torch_k9.py holds the K9 steps (the
    JAX step's density calls take the port's positions): losses within
    rtol 1e-3, per-level table-gradient sums within 1e-3 of the level's L1
    mass;
  * render_rays with a packed table: as tests/test_torch_render.py holds
    the unpacked render; with bf16 rows the port's packed render is
    bit-equal to its unpacked one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_k9 import _positions_from_host
from test_torch_render import _check
from test_torch_render import scene  # noqa: F401  (a fixture)
from test_torch_render import H as RH
from test_torch_render import W as RW
from test_torch_train import (CFG_KW, MODEL_KW, N_RAYS, OCC_RES, H, W,
                              _batch, _jax_draws, _jax_state_of, _level_sums,
                              _stash_grads, _t)

from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.models import hash_encoding as jhe
from ucsa_neural_rendering_tpu.models import packed_table as jpt
from ucsa_neural_rendering_tpu.ops import occupancy as jocc
from ucsa_neural_rendering_tpu.ops import renderer as jr
from ucsa_neural_rendering_tpu.train import nerf_trainer as jnt
from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
from ucsa_neural_rendering_tpu_torch.models import (SemanticNeRF,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as the
from ucsa_neural_rendering_tpu_torch.models import packed_table as tpt
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import renderer as tr
from ucsa_neural_rendering_tpu_torch.train import nerf_trainer as tnt

JDTYPES = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}
UINT = {"bf16": (np.uint16, torch.int16), "fp8": (np.uint8, torch.uint8)}


def _spec_pair(n_levels, n_features):
    """The port's and the JAX package's spec at log2 10, base 4, scale 1.5:
    resolutions 4 … 30 (8 levels: 4 … 68), dense and hashed levels."""
    args = (n_levels, n_features, 10, 4, 1.5)
    spec = the.make_spec(*args)
    assert not all(spec.hashed) and any(spec.hashed)
    return spec, jhe.make_spec(*args)


def _table(rng, spec, spread=True):
    """f32 table: values spanning 2^-12 … 2^8 (so that sums round and fp8
    loses bits, within its range), or, with spread False, U(-1, 1)."""
    shape = (spec.table_size, spec.n_features)
    t = rng.uniform(-1, 1, shape)
    if spread:
        t = t * 2.0 ** rng.integers(-12, 9, shape)
    return t.astype(np.float32)


def _x01(rng, n):
    """n points uniform in [0, 1]³, the first 8 at eighths of the cube,
    its corners and faces among them (x01 = 1 clips a packed level's cell
    to res − 1). The uniform points' x01·res is not exact in f32:
    where jitted XLA forms a frac as an FMA it rounds once where the port
    rounds twice, so _assert_encode allows the few elements that moves."""
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0], [1, 0.75, 0.25],
             [0.25, 0.5, 0.75], [0, 1, 0.5], [0.125, 0.375, 1], [1, 0, 1]]
    return x


def _bits(a, dtype):
    """The bits of packed rows (a numpy or torch array) as numpy ints."""
    np_int, t_int = UINT[dtype]
    if isinstance(a, torch.Tensor):
        return a.view(t_int).numpy().view(np_int)
    return np.asarray(a).view(np_int)


def _abs_blend(rows, w):
    """_blend's Σ |product| in f32: the scale of a blend's rounding."""
    return (rows.abs() * w.to(torch.bfloat16).float().abs()[..., None]
            ).sum(-2)


def _assert_encode(out, ref, encode):
    """out (the port's) bit-equal to ref (JAX's) on at least 0.999 of the
    elements and elsewhere within 2^-5 of Σ |product| of the element's
    blend (encode() with _blend swapped for _abs_blend; measured up to
    1.2e-2): jitted XLA forms some fracs x·res − cell with one rounding (an
    FMA) where the port rounds twice, which moves a weight by up to an ulp
    of x·res (a large share of a weight near 0, at the points on cell
    faces), and sums 8 corners in another order."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(the, "_blend", _abs_blend)
        mp.setattr(tpt, "_blend", _abs_blend)
        mass = encode().float().abs().numpy()
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    diff = np.abs(out - ref)
    assert (diff == 0).mean() >= 0.999, ((diff > 0).sum(), diff.size)
    assert (diff <= 2.0 ** -5 * mass).all(), (diff / mass).max()


@pytest.mark.parametrize("budget", [0, 63, 64, 125, 10 ** 9])
def test_choose_n_packed_and_offsets_match_jax(budget):
    spec, jspec = _spec_pair(6, 2)
    k = tpt.choose_n_packed(spec, budget)
    assert k == jpt.choose_n_packed(jspec, budget)
    assert tpt.packed_offsets(spec, k) == jpt.packed_offsets(jspec, k)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("n_features", [2, 4])
def test_packed_rows_bit_equal_to_jax(n_features, dtype):
    """build_packed_table (on a CPU tensor: its plain version) against the
    JAX package's with every level packed, on a table holding ±inf, 464
    (the tie that rounds to 448 in fp8), 464 + 1 ulp, 500 and subnormals:
    the rows' bits equal, fp8's NaN for |x| > 464 and ±inf included; at
    n_packed 0, 1 and 3 the leading rows of those."""
    spec, jspec = _spec_pair(6, n_features)
    rng = np.random.default_rng(0)
    table = _table(rng, spec)
    edge = np.array([np.inf, -np.inf, 464.0, np.nextafter(
        np.float32(464), np.float32(500)), -500.0, 448.0, 2.0 ** -10,
        1.5 * 2.0 ** -9, -2.5 * 2.0 ** -9, 3e38], np.float32)
    table.reshape(-1)[::97][:edge.size] = edge
    k = spec.n_levels
    ref = jax.jit(lambda t: jpt.build_packed_table(t, jspec, k,
                                                   JDTYPES[dtype]).data)(
        table)
    got = tpt.build_packed_table(_t(table), spec, k, dtype)
    assert got.n_packed == k and got.data.dtype == tpt.ROW_DTYPES[dtype]
    assert got.data.shape == ref.shape
    np.testing.assert_array_equal(_bits(got.data, dtype), _bits(ref, dtype))
    if dtype == "fp8":
        assert np.isnan(got.data.float().numpy()).any()
    # a shorter prefix of levels packs the same leading rows
    for k in (0, 1, 3):
        part = tpt.build_packed_table(_t(table), spec, k, dtype).data
        assert part.shape[0] == tpt.packed_offsets(spec, k)[1]
        assert torch.equal(_t(_bits(part, dtype)),
                           _t(_bits(got.data, dtype))[:part.shape[0]])


def test_packed_rows_layout():
    """Row of cell (x, y, z) of a hashed level holds the 8 corners'
    features, corner c moving axis a by (c >> a) & 1, each the row the
    unpacked lookup reads."""
    spec, _ = _spec_pair(6, 2)
    lvl = spec.n_levels - 1
    assert spec.hashed[lvl]
    table = torch.randn((spec.table_size, 2), dtype=torch.float32)
    pt = tpt.build_packed_table(table, spec, spec.n_levels)
    res = spec.resolutions[lvl]
    offs, _ = tpt.packed_offsets(spec, spec.n_levels)
    cell = (2, 3, 1)
    row = pt.data[offs[lvl] + (cell[2] * res + cell[1]) * res + cell[0]]
    for c in range(8):
        v = [torch.tensor([cell[a] + ((c >> a) & 1)]) for a in range(3)]
        idx = the._hash_index(*v, res, spec.sizes[lvl], True)
        assert torch.equal(row[2 * c:2 * c + 2],
                           table[spec.offsets[lvl] + idx[0]].bfloat16())


@pytest.mark.parametrize("n_packed", [0, 1, 3, "L"])
@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("mode", ["exact", "probe", "face"])
def test_packed_encodes_match_jax(mode, dtype, n_packed):
    """The three modes of hash_encode_packed (on CPU tensors: their plain
    version) against hash_encode_packed / hash_encode_packed_probe /
    hash_encode_packed_face, jitted, JAX's k == 0 and k == L branches
    included, at 6 levels × 4 (3 dense, 3 hashed), at x01 edges, as
    _assert_encode holds them."""
    spec, jspec = _spec_pair(6, 4)
    k = spec.n_levels if n_packed == "L" else n_packed
    rng = np.random.default_rng(1)
    table = _table(rng, spec)
    x = _x01(rng, 2048)
    jfn = {"exact": jpt.hash_encode_packed,
           "probe": jpt.hash_encode_packed_probe,
           "face": jpt.hash_encode_packed_face}[mode]
    data = jpt.build_packed_table(jnp.asarray(table), jspec, k,
                                  JDTYPES[dtype]).data
    ref = jax.jit(lambda t, d, x: jfn(t, jpt.PackedTable(d, k), x, jspec))(
        table, data, x).astype(jnp.float32)
    tb = _t(table).to(torch.bfloat16)
    packed = tpt.build_packed_table(_t(table), spec, k, dtype)
    encode = lambda: tpt.hash_encode_packed(tb, packed, _t(x), spec, mode)
    out = encode()
    assert out.dtype == torch.bfloat16 and out.shape == (2048, spec.out_dim)
    _assert_encode(out, ref, encode)


@pytest.mark.parametrize("n_features", [2, 4])
def test_packed_exact_bf16_equals_hash_encode(n_features):
    """With bf16 rows the exact mode is hash_encode, bit for bit, at
    n_packed 0, 1, 3 and L: the relayout changes which memory a level reads,
    not what it blends (at x01 = 1 the clipped cell's far corners are the
    clamped vertices)."""
    spec, _ = _spec_pair(8, n_features)
    rng = np.random.default_rng(2)
    table = _t(_table(rng, spec))
    tb = table.to(torch.bfloat16)
    x = _t(_x01(rng, 2048))
    ref = the.hash_encode(tb, x, spec)
    for k in (0, 1, 3, spec.n_levels):
        packed = tpt.build_packed_table(table, spec, k)
        assert torch.equal(tpt.hash_encode_packed(tb, packed, x, spec), ref)


def test_sampled_corner_indices_levels_match_jax():
    """levels= draws each level's corner by its absolute level number."""
    spec, jspec = _spec_pair(8, 2)
    x = _x01(np.random.default_rng(3), 2048)
    for levels in (range(3, 8), range(0, 2), range(7, 8)):
        ref = jax.jit(lambda x: jhe.sampled_corner_indices(x, jspec,
                                                           levels))(x)
        got = the.sampled_corner_indices(_t(x), spec, levels)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert torch.equal(got, the.sampled_corner_indices(
            _t(x), spec)[:, levels.start:levels.stop])


@pytest.mark.parametrize("sfwd,call", [
    (False, "render"), (False, "probe"), (False, "train"), (True, "train"),
    ("fine", "train"), ("face", "train")], ids=[
    "render", "probe", "train-exact", "train-stochastic", "train-fine",
    "train-face"])
@pytest.mark.parametrize("with_packed", [False, True],
                         ids=["unpacked", "packed"])
def test_encoder_dispatch_matches_jax(sfwd, call, with_packed):
    """HashGridEncoding(stochastic_fwd=sfwd)(x01, probe, train, packed)
    against the JAX package's module on the same table and bf16 packed
    table (3 of 6 levels): every branch of its dispatch picks the encode
    JAX's picks (as _assert_encode holds them); stochastic_fwd matters only
    to training calls."""
    spec, jspec = _spec_pair(6, 4)
    rng = np.random.default_rng(4)
    table = _table(rng, spec, spread=False)
    x = _x01(rng, 1024)
    probe, train = call == "probe", call == "train"
    jenc = jhe.HashGridEncoding(jspec, stochastic_grad=True,
                                stochastic_fwd=sfwd)
    data = jpt.build_packed_table(jnp.asarray(table), jspec, 3).data

    def japply(t, d, x):
        pk = jpt.PackedTable(d, 3) if with_packed else None
        return jenc.apply({"params": {"table": t}}, x, probe, train, pk)

    ref = jax.jit(japply)(table, data, x).astype(jnp.float32)
    enc = the.HashGridEncoding(spec, "cpu", stochastic_fwd=sfwd)
    with torch.no_grad():
        enc.table.copy_(_t(table))
        packed = (tpt.build_packed_table(enc.table, spec, 3)
                  if with_packed else None)
        encode = lambda: enc(_t(x), probe=probe, train=train, packed=packed)
        _assert_encode(encode(), ref, encode)


@pytest.mark.parametrize("sfwd,bwd", [(False, False), (False, True),
                                      ("fine", True), ("face", "face")],
                         ids=["exact", "stochastic_grad", "fine", "face"])
def test_packed_training_encoders_table_gradients(sfwd, bwd):
    """A training encode through a packed table (bf16, 3 of 8 levels)
    gives the f32 table the unpacked backward's gradient, bit for bit:
    hash_encode_packed_train's exact or stochastic one, the hybrid's
    single-corner one, the face hybrid's face one (the JAX package's
    test_packed_train_grad_parity); no gradient reaches the packed rows or
    x01; the packed train forward equals hash_encode (bf16 rows)."""
    spec, _ = _spec_pair(8, 4)
    rng = np.random.default_rng(5)
    table = _t(_table(rng, spec, spread=False))
    x = _t(_x01(rng, 4096)).requires_grad_()
    g = _t(rng.normal(size=(4096, spec.out_dim)).astype(np.float32)
           ).to(torch.bfloat16)
    enc = the.HashGridEncoding(spec, "cpu", stochastic_grad=bwd is True,
                               stochastic_fwd=sfwd)
    with torch.no_grad():
        enc.table.copy_(table)
        packed = tpt.build_packed_table(enc.table, spec, 3)
    out = enc(x, train=True, packed=packed)
    out.backward(g)
    assert x.grad is None and not packed.data.requires_grad
    ref = the.hash_encode_bwd_plain(x.detach(), g, spec, bwd)
    assert torch.equal(enc.table.grad, ref)
    if sfwd is False:
        assert torch.equal(out, the.hash_encode(table.bfloat16(),
                                                x.detach(), spec))


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    return jax.tree_util.tree_map(np.array, jax.jit(JNeRF(**MODEL_KW).init)(
        jax.random.key(0), x, d)["params"])


@pytest.mark.parametrize("mode", [False, "face"])
def test_packed_train_steps_match_jax(jax_params, monkeypatch, mode):
    """2 NeRFTrainer.train_steps of SemanticNeRF(stochastic_fwd=mode) with
    train packing on (UCSA_TRAIN_PACKED_ON_CPU=1; the default budget 2^21
    packs 2 of the 4 levels, resolutions 16 and 80) against the JAX
    trainer's, as tests/test_torch_k9.py holds the K9 steps: from the same
    weights, an all-ones grid and JAX's draws, the JAX step's density calls
    at the port's positions, the JAX trainer resynced to the port's state
    before step 2; every loss within rtol 1e-3 and the per-level table
    gradient sums within 1e-3 of the level's L1 mass. Mode False: the
    packed exact step (the JAX package's test_train_step_packed_matches_
    unpacked; "face": test_face_encoding's hybrid step)."""
    monkeypatch.setenv("UCSA_TRAIN_PACKED_ON_CPU", "1")
    given = []
    jm, computed = _positions_from_host(
        JNeRF(**MODEL_KW, stochastic_fwd=mode), given)
    cfg_j = jr.RenderConfig(**CFG_KW)
    jt = jnt.NeRFTrainer(jm, cfg_j, lr=1e-2, n_rays=N_RAYS, image_hw=(H, W))
    jt.tx = optax.chain(_stash_grads(), jt.tx)
    jt.occ_cfg = jocc.OccupancyConfig(resolution=OCC_RES)
    # jt.init's optimizer state, without its op-by-op model init
    opt_state = jt.tx.init(jax_params)

    tt = tnt.NeRFTrainer(
        SemanticNeRF(**MODEL_KW, device="cpu", stochastic_fwd=mode),
        tr.RenderConfig(**CFG_KW), lr=1e-2, n_rays=N_RAYS, image_hw=(H, W),
        device="cpu")
    tt.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES)
    tt.init(params_from_jax(jax_params))
    assert tt.train_packed().n_packed == 2
    grid_t = tt.init_occupancy()
    spec = tt.model.encoder.spec
    b = _batch(np.random.default_rng(8))
    batch_t = {k: _t(v) for k, v in b.items()}
    port_points, own = tr._points, []

    def recorded_points(*a):
        own.append(port_points(*a))
        return own[-1]

    monkeypatch.setattr(tr, "_points", recorded_points)
    for step in range(2):
        if step:
            p_j, opt_state = _jax_state_of(tt, opt_state)
        else:
            p_j = jax_params
        key = jax.random.key(500 + step)
        own.clear()
        parts_t = tt.train_step(batch_t, None, grid_t,
                                draws=_jax_draws(key, cfg_j))
        assert len(own) == 2
        computed.clear()
        given[:] = [x.numpy() for x in own]
        p_j, opt_state, parts_j = jax.block_until_ready(jt.train_step(
            p_j, opt_state, b, key, occ_grid=grid_t.numpy()))
        assert len(computed) == 2 and not given
        for x_j, x_t in zip(computed, own):
            assert np.abs(x_j - x_t.numpy()).max() <= 1e-5
        for k in parts_j:
            a, ref = float(parts_t[k]), float(parts_j[k])
            assert np.isfinite(a), (step, k)
            assert abs(a - ref) <= 1e-3 * abs(ref), (step, k, a, ref)
        sums_j, mass_j = _level_sums(opt_state[0]["encoder"]["table"], spec)
        sums_t, _ = _level_sums(tt.model.encoder.table.grad, spec)
        assert (mass_j > 0).all()
        assert (np.abs(sums_t - sums_j) <= 1e-3 * mass_j[:, None]).all(), \
            (step, np.abs(sums_t - sums_j).max(-1) / mass_j)


def test_packed_train_step_equals_unpacked_step(jax_params, monkeypatch):
    """With bf16 rows a packed step is the unpacked step, bit for bit: the
    losses, every gradient and, after Adam, every parameter and moment
    (the JAX package's test_train_step_packed_matches_unpacked)."""
    monkeypatch.setenv("UCSA_TRAIN_PACKED_ON_CPU", "1")
    b = {k: _t(v) for k, v in _batch(np.random.default_rng(9)).items()}
    draws = _jax_draws(jax.random.key(600), jr.RenderConfig(**CFG_KW))
    out = []
    for budget in (0, 2 ** 21):
        tt = tnt.NeRFTrainer(
            SemanticNeRF(**MODEL_KW, device="cpu"),
            tr.RenderConfig(**CFG_KW, train_packed_max_entries=budget),
            lr=1e-2, n_rays=N_RAYS, image_hw=(H, W), device="cpu")
        tt.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES)
        tt.init(params_from_jax(jax_params))
        assert (tt.train_packed() is None) == (budget == 0)
        parts = tt.train_step(b, None, tt.init_occupancy(), draws=draws)
        out.append((parts, dict(tt.model.named_parameters()),
                    tt.optimizer.state))
    (p0, w0, s0), (p1, w1, s1) = out
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    for n in w0:
        assert torch.equal(w0[n], w1[n]) and torch.equal(w0[n].grad,
                                                         w1[n].grad), n
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s0[w0[n]][m], s1[w1[n]][m]), (n, m)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_render_rays_packed_matches_jax(scene, dtype):  # noqa: F811
    """render_rays with the model's packed table (pack_table at 2^23: 4 of
    the 8 levels, resolutions 16 … 128) against jr.render_rays with JAX's,
    on the same 256 rays, 16 + 16 occupancy-placed samples: the render
    tolerances of tests/test_torch_render.py. With bf16 rows the render
    equals the port's unpacked one bit for bit (the JAX package's
    test_render_rays_packed_parity). (The packed probe is held at shared
    points, test_packed_encodes_match_jax: a probe's corner hashes its
    position's bits, which jitted XLA rounds otherwise.)"""
    jm, params, tm, grid, pose, intr = scene
    rays = get_rays(pose, intr, RH, RW, device="cpu")
    ro, rd, dn = (rays[k][:256] for k in ("rays_o", "rays_d",
                                           "direction_norms"))
    kw = dict(num_steps=16, upsample_steps=16)
    budget = 2 ** 23
    packed = tm.pack_table(budget, dtype)
    assert packed.n_packed == 4
    jout = jax.jit(lambda p, o, d, n, g: jr.render_rays(
        jm, {"params": p}, o, d, n, None, jr.RenderConfig(**kw), g,
        packed=jm.pack_table(p, budget, dtype)))(
        params, ro.numpy(), rd.numpy(), dn.numpy(), grid)
    g = torch.from_numpy(grid)
    tout = tr.render_rays(tm, ro, rd, dn, tr.RenderConfig(**kw), g, packed)
    _check(jout, tout)
    if dtype == "bf16":
        ref = tr.render_rays(tm, ro, rd, dn, tr.RenderConfig(**kw), g)
        for k in ref:
            assert torch.equal(tout[k], ref[k]), k


def test_packing_enabled_gate(monkeypatch):
    """On a CUDA device always; on the CPU never, but a training step's
    under UCSA_TRAIN_PACKED_ON_CPU=1."""
    monkeypatch.delenv("UCSA_TRAIN_PACKED_ON_CPU", raising=False)
    assert tr.packing_enabled(torch.device("cuda"))
    assert tr.packing_enabled("cuda:0", train=True)
    assert not tr.packing_enabled("cpu")
    assert not tr.packing_enabled("cpu", train=True)
    monkeypatch.setenv("UCSA_TRAIN_PACKED_ON_CPU", "1")
    assert tr.packing_enabled("cpu", train=True)
    assert not tr.packing_enabled("cpu")


def test_packed_cache_keys_on_table_version_budget_and_dtype():
    """PackedTableCache: None at a budget ≤ 0 or one that packs no level;
    else one pack per (table version, budget, dtype): the same object
    again, a new pack after a dtype or budget swap and after the table
    changes in place (the JAX package's test_packed_cache_keys_on_cfg)."""
    from dataclasses import replace
    model = SemanticNeRF(bound=1.0, num_semantic_classes=4, n_levels=4,
                         log2_hashmap_size=10, device="cpu")
    cache = tpt.PackedTableCache(model)
    cfg = tr.RenderConfig(packed_max_entries=2 ** 12, packed_dtype="bf16")
    p1 = cache(cfg)
    assert p1 is not None and p1.data.dtype == torch.bfloat16
    assert cache(cfg) is p1
    p2 = cache(replace(cfg, packed_dtype="fp8"))
    assert p2 is not p1 and p2.data.dtype == torch.float8_e4m3fn
    p3 = cache(replace(cfg, packed_max_entries=10 ** 6))
    assert p3.n_packed > p1.n_packed
    with torch.no_grad():
        model.encoder.table.add_(1.0)
    p4 = cache(replace(cfg, packed_max_entries=10 ** 6))
    assert p4 is not p3 and not torch.equal(p4.data.float(),
                                            p3.data.float())
    assert cache(replace(cfg, packed_max_entries=0)) is None
    assert cache(replace(cfg, packed_max_entries=15)) is None
    cache.clear()
    assert cache(replace(cfg, packed_max_entries=10 ** 6)) is not p4


@pytest.mark.parametrize("sfwd", [False, True, "fine", "face"])
def test_trainer_packs_where_the_gate_says(monkeypatch, sfwd):
    """NeRFTrainer.packed_for (the renders' table) is None on the CPU and
    the cache's table where packing_enabled says; train_packed packs under
    UCSA_TRAIN_PACKED_ON_CPU=1 but not under stochastic_fwd True, whose
    training encode reads no packed table (the JAX package's dispatch)."""
    monkeypatch.delenv("UCSA_TRAIN_PACKED_ON_CPU", raising=False)
    tt = tnt.NeRFTrainer(
        SemanticNeRF(**MODEL_KW, device="cpu", stochastic_fwd=sfwd),
        tr.RenderConfig(**CFG_KW), n_rays=N_RAYS, image_hw=(H, W),
        device="cpu")
    assert tt.packed_for() is None and tt.train_packed() is None
    monkeypatch.setenv("UCSA_TRAIN_PACKED_ON_CPU", "1")
    assert tt.packed_for() is None
    assert (tt.train_packed() is None) == (sfwd is True)
    monkeypatch.setattr(tnt, "packing_enabled", lambda device, train=False:
                        True)
    packed = tt.packed_for()
    assert packed is not None and packed is tt.packed_for()
    assert packed.data.dtype == torch.float8_e4m3fn
