"""K9, the stochastic training encoders (`stochastic_fwd=True` and "face"),
against the JAX package on the CPU, at small sizes: the salted position
hash, the face geometry, the two forwards, their table gradients, the
model's training density and NeRFTrainer.train_step. The same numpy-seeded
inputs go through both sides; the JAX side runs jitted, as its trainer
runs it.

Tolerances:
  * the salted uniforms, the face's indices and weights, and both forwards
    (a copy of one bf16 row; exact f32 products of 4 rows summed in order
    and rounded once, what XLA makes of the face blend under jit):
    bit-equal;
  * table gradients (f32 scatter of bf16 cotangents): per element within
    1e-6 of the sum of the |contributions| landing on it (f32 sums in
    another order);
  * the training density on identical positions: see
    test_density_train_matches_jax;
  * the training step: see test_train_steps_match_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import (CFG_KW, MODEL_KW, N_RAYS, OCC_RES, H, W,
                              _batch, _jax_draws, _jax_state_of, _level_sums,
                              _stash_grads, _t)

from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.models import hash_encoding as jhe
from ucsa_neural_rendering_tpu.ops import occupancy as jocc
from ucsa_neural_rendering_tpu.ops import renderer as jr
from ucsa_neural_rendering_tpu.train import nerf_trainer as jnt
from ucsa_neural_rendering_tpu_torch.models import (SemanticNeRF,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.models import hash_encoding as the
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import renderer as tr
from ucsa_neural_rendering_tpu_torch.train import nerf_trainer as tnt

SALTS = (0, jhe._FACE_SALT_E1, jhe._FACE_SALT_E2)


def _spec_pair(n_levels=8, n_features=4):
    """The port's and the JAX package's spec at log2 12 and base resolution
    8, bound 1: dense coarse levels and hashed fine ones."""
    args = (n_levels, n_features, 12, 8)
    spec = the.make_spec(*args, the.ngp_per_level_scale(
        1.0, n_levels, base_resolution=8))
    assert not all(spec.hashed) and any(spec.hashed)
    return spec, jhe.make_spec(*args, jhe.ngp_per_level_scale(
        1.0, n_levels, base_resolution=8))


def _x01(rng, n):
    """Points in [0, 1]³ with the cube's corners, faces, cell vertices and
    ties of |frac - 0.5| between axes (frac 0.25 and 0.75)."""
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0], [1e-7, 1 - 1e-7, 0.25],
             [0.25, 0.5, 0.75], [1 / 3, 2 / 3, 0.1], [0.25, 0.75, 0.25],
             [1, 0, 1]]
    return x


def test_face_salts_match_jax():
    assert (the._FACE_SALT_E1, the._FACE_SALT_E2) == SALTS[1:]


@pytest.mark.parametrize("salt", SALTS, ids=["0", "E1", "E2"])
def test_corner_uniform_salted_bit_equal_to_jax(salt):
    x = _x01(np.random.default_rng(1), 4096)
    ref = np.asarray(jax.jit(lambda x: jhe._corner_uniform(x, 8, salt))(x))
    out = the._corner_uniform(_t(x), 8, salt).numpy()
    np.testing.assert_array_equal(out, ref)
    if salt:  # another stream than the corner draw's
        assert (out != the._corner_uniform(_t(x), 8).numpy()).mean() > 0.99


@pytest.mark.parametrize("n_levels,n_features", [(8, 4), (4, 2)])
def test_face_rows_and_backward_corner_bit_equal_to_jax(n_levels,
                                                        n_features):
    """sampled_face_rows (the forward's 4 face rows and bilinear weights)
    and face_corner_indices (the backward's one corner of that face, as
    `_level_face_choice` draws it) against JAX's."""
    spec, jspec = _spec_pair(n_levels, n_features)
    x = _x01(np.random.default_rng(2), 8192)
    ji, jw = jax.jit(lambda x: jhe.sampled_face_rows(x, jspec))(x)
    ti, tw = the.sampled_face_rows(_t(x), spec)
    assert ti.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)

    @jax.jit
    def choice(x):
        u = [jhe._corner_uniform(x, n_levels, s) for s in SALTS]
        return jnp.stack([
            jhe._level_face_choice(x, jspec.resolutions[lvl],
                                   jspec.sizes[lvl], jspec.hashed[lvl],
                                   *(v[:, lvl] for v in u))
            + jspec.offsets[lvl] for lvl in range(n_levels)], 1)

    tc = the.face_corner_indices(_t(x), spec)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(choice(x)))
    # the backward's corner is one of the forward's 4 face rows
    assert (tc[..., None] == ti).any(-1).all()


@pytest.mark.parametrize("n_features", [2, 4])
@pytest.mark.parametrize("mode", [True, "face"], ids=["stochastic", "face"])
def test_forward_encodes_bit_equal_to_jax(mode, n_features):
    """hash_encode_sampled_plain / hash_encode_face_plain (and their
    wrappers on CPU tensors) against hash_encode_stochastic_fwd /
    hash_encode_stochastic_face, jitted, on a table spanning 2^-12..1 so
    that the face blend's f32 sums round."""
    spec, jspec = _spec_pair(8, n_features)
    rng = np.random.default_rng(3)
    table = (rng.uniform(-1, 1, (spec.table_size, n_features))
             * 2.0 ** rng.integers(-12, 1, (spec.table_size, n_features))
             ).astype(np.float32)
    x = _x01(rng, 8192)
    jfn, plain, wrapper = (
        (jhe.hash_encode_stochastic_face, the.hash_encode_face_plain,
         the.hash_encode_face) if mode == "face" else
        (jhe.hash_encode_stochastic_fwd, the.hash_encode_sampled_plain,
         the.hash_encode_sampled))
    ref = np.asarray(jax.jit(lambda t, x: jfn(t, x, jspec))(table, x)
                     .astype(jnp.float32))
    tb = _t(table).to(torch.bfloat16)
    out = plain(tb, _t(x), spec)
    assert out.dtype == torch.bfloat16 and out.shape == (8192, spec.out_dim)
    np.testing.assert_array_equal(out.float().numpy(), ref)
    assert torch.equal(wrapper(tb, _t(x), spec), out)


def _draws_either_way(x, spec, mode):
    """[N, L] bool: the (point, level)s whose draw (mode True: the corner;
    "face": the sampled axis, its bit and the backward's two exact axes'
    bits) would differ if frac = x·res − floor(x·res) were rounded once,
    as an FMA does, rather than twice. XLA's CPU code generator contracts
    that product and difference into an FMA inside some fusions and not in
    others (jax.vjp of hash_encode_stochastic_face draws another face than
    its own jitted forward for ~1 in 30,000 (point, level)s: a u within
    half an ulp of pos of frac), so on these the JAX package's draw depends
    on how XLA fused the program; the port rounds twice, as written."""
    n_levels = spec.n_levels
    us = [the._corner_uniform(_t(x), n_levels, s).numpy() for s in SALTS]
    either = np.zeros((x.shape[0], n_levels), bool)
    for lvl, res in enumerate(spec.resolutions):
        u = [v[:, lvl] for v in us]
        pos = x * np.float32(res)
        floor = np.floor(pos)
        draws = []
        for frac in (pos - floor,
                     (x.astype(np.float64) * res - floor).astype(np.float32)):
            if mode == "face":
                a = np.argmax(np.abs(frac - np.float32(0.5)), -1)
                f = [np.take_along_axis(frac, ax[:, None], 1)[:, 0]
                     for ax in (a, (a + 1) % 3, (a + 2) % 3)]
                draws.append(np.stack([a] + [v < fk for v, fk in zip(u, f)],
                                      -1))
            else:
                w = np.ones((x.shape[0], 8), np.float32)
                for ax in range(3):
                    bit = (np.arange(8) >> ax) & 1
                    w = w * np.where(bit == 1, frac[:, ax:ax + 1],
                                     np.float32(1) - frac[:, ax:ax + 1])
                cdf = np.cumsum(w, -1, dtype=np.float32)
                draws.append((u[0][:, None] >= cdf).sum(-1)[:, None])
        either[:, lvl] = (draws[0] != draws[1]).any(-1)
    return either


@pytest.mark.parametrize("mode", [True, "face"], ids=["stochastic", "face"])
def test_table_gradients_match_jax_vjp(mode):
    """HashGridEncoding(stochastic_fwd=mode)'s training encode: its forward
    and, through autograd, the f32 table's gradient against jax.vjp of
    hash_encode_stochastic_fwd / hash_encode_stochastic_face on identical
    x01 and a seeded bf16 cotangent; the mode's plain backward gives the
    same gradient; x01 gets none. The (point, level)s that JAX may draw
    either way (_draws_either_way, under 1e-3 of them) are left out: the
    forward there is not compared, and their cotangent is 0 on both
    sides."""
    spec, jspec = _spec_pair()
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (spec.table_size, 4)).astype(np.float32)
    x = _x01(rng, 4096)
    either = _draws_either_way(x, spec, mode)
    assert either.mean() < 1e-3
    either = np.repeat(either, 4, axis=1)
    g = np.where(either, 0, rng.normal(size=(4096, 32))).astype(np.float32)
    g_t = _t(g).to(torch.bfloat16)
    fn = (jhe.hash_encode_stochastic_face if mode == "face"
          else jhe.hash_encode_stochastic_fwd)

    @jax.jit
    def vjp(t, x, g):
        out, pull = jax.vjp(lambda t: fn(t, x, jspec), t)
        return out, pull(g.astype(jnp.bfloat16))[0]

    ref_out, ref = (np.asarray(a.astype(jnp.float32))
                    for a in vjp(table, x, g))
    enc = the.HashGridEncoding(spec, "cpu", stochastic_fwd=mode)
    with torch.no_grad():
        enc.table.copy_(_t(table))
    xt = _t(x).requires_grad_()
    out = enc(xt, train=True)
    np.testing.assert_array_equal(out.detach().float().numpy()[~either],
                                  ref_out[~either])
    out.backward(g_t)
    assert xt.grad is None
    grad = enc.table.grad.numpy()
    mass = the.hash_encode_bwd(_t(x), g_t.abs(), spec, mode).numpy()
    assert (np.abs(grad - ref) <= 1e-6 * mass + 1e-30).all()
    assert (ref != 0).sum() > 1000
    np.testing.assert_array_equal(
        the.hash_encode_bwd_plain(_t(x), g_t, spec, mode).numpy(), grad)


def test_face_backward_only_reaches_rows_the_forward_read():
    """As the JAX package's test_face_encoding checks its own: every row
    the face backward touches is one of the face rows its forward read
    (pairing the face forward with the trilinear draw would be biased), and
    the unweighted single-row scatter keeps each level's mass exact."""
    spec, _ = _spec_pair(8, 2)
    rng = np.random.default_rng(5)
    x = _t(rng.uniform(0, 1, (20000, 3)).astype(np.float32))
    g = torch.ones((20000, spec.out_dim), dtype=torch.bfloat16)
    grad = the.hash_encode_bwd(x, g, spec, "face")
    read = torch.zeros(spec.table_size, dtype=torch.bool)
    read[the.sampled_face_rows(x, spec)[0].reshape(-1)] = True
    touched = grad.abs().amax(1) > 0
    assert touched.sum() > 1000
    assert not (touched & ~read).any()
    assert float(grad.double().sum()) == 20000 * spec.n_levels * 2
    # the trilinear draw reaches rows outside the face
    stoch = the.hash_encode_bwd(x, g, spec, True).abs().amax(1) > 0
    assert (stoch & ~read).any()


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    return jax.tree_util.tree_map(np.array, jax.jit(JNeRF(**MODEL_KW).init)(
        jax.random.key(0), x, d)["params"])


@pytest.mark.parametrize("mode", [False, True, "face", "fine"])
def test_density_train_matches_jax(jax_params, mode):
    """SemanticNeRF(stochastic_fwd=mode).density(x, train) against JAX's,
    weights from params_from_jax (the table U(-0.5, 0.5), so that the draw
    matters): train=True takes the mode's encoder ("fine" without a packed
    table: the exact one), train=False the exact encode whatever the mode.
    Bound 1: x01 = (x + 1) / 2 has the same bits on both sides. The
    encoders' features are equal on at least 0.999 of the rows (the exact
    encode is within a bf16 ulp of JAX's, test_torch_kernels_plain; a
    sampled draw can go either way, _draws_either_way). On those rows the
    bf16 MLPs may still round an occasional element to the other neighbour
    (as in test_torch_train): sigma within rtol 1e-2 (the exp of a bf16
    logit, one ulp of which is ~0.4 % of sigma) and within rtol 1e-6 (XLA's
    exp and torch's differ in the last bit) on at least 0.999 of the rows;
    geo_feat within one bf16 ulp of its magnitude and bit-equal on at least
    0.999 of the rows."""
    params = dict(jax_params, encoder={"table": np.random.default_rng(6)
                                       .uniform(-0.5, 0.5, jax_params[
                                           "encoder"]["table"].shape)
                                       .astype(np.float32)})
    jm = JNeRF(**MODEL_KW, stochastic_fwd=mode)
    tm = SemanticNeRF(**MODEL_KW, device="cpu", stochastic_fwd=mode)
    tm.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(7).uniform(-1, 1, (2048, 3)).astype(np.float32)
    outs = {}
    for train in (True, False):
        @jax.jit
        def density(x):
            feats = jm.apply({"params": params}, (x + 1.0) / 2.0, train=train,
                             method=lambda m, x01, train: m.encoder(
                                 x01, train=train))
            return feats, *jm.apply({"params": params}, x, train,
                                    method="density")

        jf, js, jg = (np.asarray(a.astype(jnp.float32)) for a in density(x))
        with torch.no_grad():
            tf = tm.encoder((_t(x) + 1.0) / 2.0, train=train).float().numpy()
            ts, tg = tm.density(_t(x), train=train)
        same = (tf == jf).all(-1)
        assert same.mean() >= 0.999, same.mean()
        ts, tg = ts.numpy()[same], tg.float().numpy()[same]
        np.testing.assert_allclose(ts, js[same], rtol=1e-2)
        assert (np.abs(ts - js[same]) <= 1e-6 * js[same]).mean() >= 0.999
        assert (np.abs(tg - jg[same]) <= np.abs(jg[same]) * 2.0 ** -7).all()
        assert (tg == jg[same]).all(-1).mean() >= 0.999
        assert np.isfinite(ts).all()
        outs[train] = tf
    if mode in (True, "face"):
        assert (outs[True] != outs[False]).mean() > 0.5
    else:
        np.testing.assert_array_equal(outs[True], outs[False])


def _positions_from_host(jm, given):
    """A JAX SemanticNeRF of jm's fields whose density calls take their
    sample positions from the host: each call hands its own positions to
    the host and goes on with the next array of `given` (its own when
    `given` is empty, as at init). Returns (model, list of the positions
    JAX computed)."""
    computed = []

    def swap(x):
        computed.append(np.array(x))
        return given.pop(0) if given else np.array(x)

    class FromHost(JNeRF):
        def density(self, x, train=False, packed=None):
            x = jax.pure_callback(
                swap, jax.ShapeDtypeStruct(x.shape, x.dtype), x)
            return super().density(x, train, packed)

    return FromHost(**{f: getattr(jm, f) for f in
                       ("bound", "num_semantic_classes", "n_levels",
                        "n_features", "log2_hashmap_size",
                        "stochastic_fwd")}), computed


def _x01_bits_share(a, b):
    """The share of sample positions whose x01 = (x + 1) / 2 (bound 1) has
    the same f32 bits in a and in b (lists of [M, 3] arrays)."""
    same = [((x + 1.0) / 2.0 == (y + 1.0) / 2.0).all(-1) for x, y in zip(a, b)]
    return float(np.concatenate(same).mean())


@pytest.mark.parametrize("mode", [True, "face"], ids=["stochastic", "face"])
def test_train_steps_match_jax(jax_params, monkeypatch, mode):
    """2 NeRFTrainer.train_steps of SemanticNeRF(stochastic_fwd=mode)
    against the JAX trainer's from the same weights, an all-ones 16³ grid
    and JAX's draws, the JAX trainer resynced to the port's state (weights,
    Adam moments and count) before step 2, as in test_torch_train.

    Under a stochastic forward a point's features are a draw hashed from
    its position's f32 bits, and the two placements sum their cdfs in other
    orders: measured here, only 0.10–0.13 of a step's x01 rows have the
    same bits on both sides, so the other ~0.9 draw unrelated corners; with
    each side at its own positions the losses drifted apart by up to 2e-3
    and the per-level table-gradient sums by 4–7 % of the level's L1 mass
    (through the MLPs' ReLU masks on features of ±1e-4), and no bound
    follows from a share that large. Nor does handing JAX's positions to
    the port help: inside its jitted step JAX's encoder draws another corner
    than its own jitted encoder does at the same positions on 0.18 of the
    rows (XLA recomputes the positions inside the encoder's fusion). So the
    port runs its step as it is, and the JAX step's density calls take the
    port's positions (held within 1e-5 of JAX's own): a share of 1 of the
    rows then has the same bits, and the limits of the exact path's
    resynced steps hold (test_torch_train): every loss within rtol 1e-3
    (measured ≤ 4.2e-5) and, per level and feature, the table gradient's
    sum within 1e-3 of the level's L1 mass (measured ≤ 2.0e-4)."""
    given = []
    jm, computed = _positions_from_host(
        JNeRF(**MODEL_KW, stochastic_fwd=mode), given)
    cfg_j = jr.RenderConfig(**CFG_KW)
    jt = jnt.NeRFTrainer(jm, cfg_j, lr=1e-2, n_rays=N_RAYS, image_hw=(H, W))
    jt.tx = optax.chain(_stash_grads(), jt.tx)
    jt.occ_cfg = jocc.OccupancyConfig(resolution=OCC_RES)
    _, opt_state = jt.init(jax.random.key(0))

    tt = tnt.NeRFTrainer(
        SemanticNeRF(**MODEL_KW, device="cpu", stochastic_fwd=mode),
        tr.RenderConfig(**CFG_KW), lr=1e-2, n_rays=N_RAYS, image_hw=(H, W),
        device="cpu")
    tt.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES)
    tt.init(params_from_jax(jax_params))
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
        key = jax.random.key(300 + step)
        own.clear()
        parts_t = tt.train_step(batch_t, None, grid_t,
                                draws=_jax_draws(key, cfg_j))
        assert len(own) == 2  # the coarse and the fine density call
        computed.clear()
        given[:] = [x.numpy() for x in own]
        p_j, opt_state, parts_j = jax.block_until_ready(jt.train_step(
            p_j, opt_state, b, key, occ_grid=grid_t.numpy()))
        assert len(computed) == 2 and not given
        for x_j, x_t in zip(computed, own):
            assert np.abs(x_j - x_t.numpy()).max() <= 1e-5
        assert _x01_bits_share(computed, [x.numpy() for x in own]) < 0.5

        for k in parts_j:
            a, ref = float(parts_t[k]), float(parts_j[k])
            assert np.isfinite(a), (step, k)
            assert abs(a - ref) <= 1e-3 * abs(ref), (step, k, a, ref)
        sums_j, mass_j = _level_sums(opt_state[0]["encoder"]["table"], spec)
        sums_t, _ = _level_sums(tt.model.encoder.table.grad, spec)
        assert (mass_j > 0).all()
        assert (np.abs(sums_t - sums_j) <= 1e-3 * mass_j[:, None]).all(), \
            (step, np.abs(sums_t - sums_j).max(-1) / mass_j)


def test_fine_trains_the_exact_step(jax_params):
    """stochastic_fwd="fine" without a packed table trains the exact
    encode, as the JAX package does off a TPU: one step from the same
    weights and draws gives the same losses and gradients as False, bit
    for bit."""
    cfg = tr.RenderConfig(**CFG_KW)
    b = {k: _t(v) for k, v in _batch(np.random.default_rng(9)).items()}
    draws = _jax_draws(jax.random.key(400), jr.RenderConfig(**CFG_KW))
    out = {}
    for mode in (False, "fine"):
        tt = tnt.NeRFTrainer(
            SemanticNeRF(**MODEL_KW, device="cpu", stochastic_fwd=mode), cfg,
            lr=1e-2, n_rays=N_RAYS, image_hw=(H, W), device="cpu")
        tt.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES)
        tt.init(params_from_jax(jax_params))
        parts = tt.train_step(b, None, tt.init_occupancy(), draws=draws)
        out[mode] = (parts, {n: p.grad.clone() for n, p in
                             tt.model.named_parameters()})
    for k, v in out[False][0].items():
        assert torch.equal(v, out["fine"][0][k]), k
    for n, g in out[False][1].items():
        assert torch.equal(g, out["fine"][1][n]), n


def test_stochastic_fwd_rejects_unknown_modes():
    with pytest.raises(ValueError, match="stochastic_fwd"):
        SemanticNeRF(**MODEL_KW, device="cpu", stochastic_fwd="coarse")
    with pytest.raises(ValueError, match="stochastic"):
        the.hash_encode_bwd_plain(torch.zeros((1, 3)),
                                  torch.zeros((1, 8)), _spec_pair(4, 2)[0],
                                  "fine")
