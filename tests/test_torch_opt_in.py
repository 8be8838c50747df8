"""The port's opt-in paths against the JAX package's, on the CPU: the
reference's dense program (no occupancy grid: stratified coarse placement,
jittered in a training step), probe placement, the exact-density refresh,
JointTrainer under nerf.use_occupancy: false, and the seg net's bf16
compute.

One JAX SemanticNeRF(bound=1, C=6, 4 levels × 2 features, 2^12 table) with
its table drawn U(-0.5, 0.5) from numpy is carried across with
params_from_jax, so both sides compute the same function. The density
output's weights are made non-positive and 8× wider, so that most of the
volume is near-empty, as in a fitted scene, and early stop finds
unsaturated rays. The occupancy grid is numpy-seeded. The JAX side runs
jitted, as its trainers run it.

The probe's sampled-corner draw hashes a position's f32 bits, and the two
sides' probe positions differ in their last bits (jitted, XLA contracts
n + (f − n)·t and o + d·z into FMAs), so that a share of the probes draw
other corners. The probe-placement renders therefore swap the probe for
the exact density on both sides (continuous in the position), and
test_density_probe_matches_jax holds the port's sampled probe to JAX's at
the same points.

Tolerances, as tests/test_torch_render.py and tests/test_torch_train.py
state them: image and semantic mass max |Δ| 3e-3, mean 1e-4; depth 3e-2,
1e-3; a training step's losses within 2e-3 relative and its table
gradient's per-level sums within 1e-3 of the level's L1 mass (a
stochastic corner is a hash of a position's f32 bits, so rows are not
compared); the placement alone within 1e-6 relative (the same f32
operations; XLA may contract a product and a sum into one FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import seg_dtypes
from test_torch_joint_trainer import (EXP, SEG_KW, _check_logs, _check_nerf,
                                      _check_seg, _joint_draws, _new_batch,
                                      _NoDropout, _stash_grads)
from test_torch_seg import SMALL, jax_weights, pin_dropout_off, rel_err
from ucsa_neural_rendering_tpu.data.rays import get_rays as jget_rays
from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.models import deeplabv3 as jdl
from ucsa_neural_rendering_tpu.ops import aabb as jaabb
from ucsa_neural_rendering_tpu.ops import occupancy as jocc
from ucsa_neural_rendering_tpu.ops import renderer as jr
from ucsa_neural_rendering_tpu.ops import sampling as jsampling
from ucsa_neural_rendering_tpu.train import nerf_trainer as jnt
from ucsa_neural_rendering_tpu.train import seg_trainer as jst
from ucsa_neural_rendering_tpu.train.joint_trainer import \
    JointTrainer as JJoint
from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3, SemanticNeRF,
                                                    deeplab_state_from_jax,
                                                    params_from_jax,
                                                    seg_compute_dtype)
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import placement as tpl
from ucsa_neural_rendering_tpu_torch.ops import renderer as tr
from ucsa_neural_rendering_tpu_torch.train import nerf_trainer as tnt
from ucsa_neural_rendering_tpu_torch.train import seg_trainer as pst
from ucsa_neural_rendering_tpu_torch.train.joint_trainer import JointTrainer

H, W = 32, 40
N_RAYS = 64
MODEL_KW = dict(bound=1.0, num_semantic_classes=6, n_levels=4, n_features=2,
                log2_hashmap_size=12)
OCC_RES = 16
INTR = np.array([36.0, 36.0, W / 2, H / 2], np.float32)
RAYS = ("rays_o", "rays_d", "direction_norms")


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(sigma_scale, level_decay=0.5):
    """(JAX model, its params, port model, grid, pose, the frame's rays):
    the table U(-0.5, 0.5), level l scaled by 2^-l (the fine levels carry
    detail, not the bulk: a field that is white noise at the finest cell
    would turn f32 rounding of the sample positions into different
    renders); the density output's weights non-positive and sigma_scale×
    wider, so that most of the volume is near-empty."""
    rng = np.random.default_rng(0)
    jm = JNeRF(**MODEL_KW)
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), x, d)["params"])
    table = rng.uniform(-0.5, 0.5, params["encoder"]["table"].shape)
    spec = SemanticNeRF(**MODEL_KW, device="cpu").encoder.spec
    for lvl in range(spec.n_levels):
        table[spec.offsets[lvl]:spec.offsets[lvl] + spec.sizes[lvl]] *= \
            level_decay ** lvl
    params["encoder"]["table"] = table.astype(np.float32)
    sigma_out = params["sigma_net"]["Dense_1"]["kernel"]
    sigma_out[:, 0] = -sigma_scale * np.abs(sigma_out[:, 0])
    tm = SemanticNeRF(**MODEL_KW, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    r = OCC_RES
    grid = np.where(rng.uniform(size=(r, r, r)) > 0.6,
                    rng.uniform(0.0, 20.0, (r, r, r)), 1e-3
                    ).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, -0.6]
    rays = get_rays(pose, INTR, H, W, device="cpu")
    return jm, params, tm, grid, pose, rays


@pytest.fixture(scope="module")
def scene():
    return _scene(8.0)


@pytest.fixture(scope="module")
def es_scene():
    """A near-emptier, smoother scene, where early stop's stage 1 leaves
    rays unsaturated."""
    return _scene(40.0, 0.25)


def _close(a, b, max_tol, mean_tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    diff = np.abs(a - b)
    assert diff.max() <= max_tol, diff.max()
    assert diff.mean() <= mean_tol, diff.mean()


def _check(jout, tout):
    _close(jout["image"], tout["image"].numpy(), 3e-3, 1e-4)
    _close(jout["semantics"], tout["semantics"].numpy(), 3e-3, 1e-4)
    _close(jout["depth"], tout["depth"].numpy(), 3e-2, 1e-3)


def _grid(grid, on):
    """(JAX grid, port grid) or (None, None)."""
    return (grid, torch.from_numpy(grid)) if on else (None, None)


class _ExactProbeJ(JNeRF):
    """The JAX model with its probe swapped for the exact density."""

    def density_probe(self, x, packed=None):
        return self.density(x)[0]


def _exact_probe(params):
    """(JAX model, port model) computing params' function, their probe the
    exact density."""
    tm = SemanticNeRF(**MODEL_KW, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    tm.density_probe = lambda x, packed=None: tm.density(x, packed=packed)[0]
    return _ExactProbeJ(**MODEL_KW), tm


def test_density_probe_matches_jax(scene):
    """The sampled-corner probe at the probe placement's points of 256 rays
    (16 stratified samples each), fed to both sides with the same bits:
    within 1e-2 relative (sigma is exp of a bf16 logit, 1 ulp of which is
    ~0.4 %)."""
    jm, params, tm, _, _, rays = scene
    ro, rd = rays["rays_o"][:256], rays["rays_d"][:256]
    z = tpl.stratified_placement(ro, rd, 1.0, 16, 0.2)
    x = tr._points(ro, rd, z, 1.0)
    with torch.no_grad():
        got = tm.density_probe(x).numpy()
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, None,
                                        method="density_probe"))(
        params, x.numpy())
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-2)


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("samples", [1, 16])
@pytest.mark.parametrize("jitter", [False, True])
def test_stratified_placement_plain_matches_jax(jitter, samples):
    """The dense coarse placement on rays that hit the box, miss it and
    exit it closer than min_near: JAX's near_far_from_aabb and
    stratified_samples (with a key: the jitter, u = its uniform draw)."""
    rng = np.random.default_rng(1)
    n = 48
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    o[:8] = rng.uniform(-0.9, 0.9, (8, 3))  # inside the box
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = -o[:4] / np.linalg.norm(o[:4], axis=-1, keepdims=True)
    o[40:] = [0.95, 0.0, 0.0]  # exits in 0.05 < min_near
    d[40:] = [1.0, 0.0, 0.0]
    key = jax.random.key(3) if jitter else None
    aabb = jnp.array([-1.0] * 3 + [1.0] * 3)

    @jax.jit
    def ref(o, d):
        near, far = jaabb.near_far_from_aabb(o, d, aabb, 0.2)
        return jsampling.stratified_samples(near, far, samples, key)

    zj = np.asarray(ref(o, d))
    u = _t(jax.random.uniform(key, (n, samples))) if jitter else None
    zt = tpl.stratified_placement(_t(o), _t(d), 1.0, samples, 0.2, u)
    assert (zj == 1e10).any(axis=-1).sum() > 0  # some rays miss
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-6)
    assert (np.diff(zt.numpy(), axis=-1) >= 0).all()


# ---------------------------------------------------------------- renders
DENSE = dict(num_steps=16, upsample_steps=16)
PROBE = dict(num_steps=16, upsample_steps=16, probe_placement=True,
             num_probe=16, occ_candidates=32)


@pytest.mark.parametrize("what", ["dense", "probe_grid", "probe_no_grid"])
def test_render_rays_matches_jax(scene, what):
    """render_rays (det) on 256 rays: the dense program (no grid, 16 + 16
    samples), and probe placement (16 probes → 16 exact samples) with and
    without a grid."""
    jm, params, tm, grid, _, rays = scene
    kw = DENSE if what == "dense" else PROBE
    if what != "dense":
        jm, tm = _exact_probe(params)
    gj, gt = _grid(grid, what == "probe_grid")
    ro, rd, dn = (rays[k][:256] for k in RAYS)
    cfg_j = jr.RenderConfig(**kw)
    jout = jax.jit(lambda p, o, d, n, g: jr.render_rays(
        jm, {"params": p}, o, d, n, None, cfg_j, g))(
        params, ro.numpy(), rd.numpy(), dn.numpy(), gj)
    tout = tr.render_rays(tm, ro, rd, dn, tr.RenderConfig(**kw), gt)
    _check(jout, tout)


# early stop: stage 1 renders 8 samples, then the top refine_fraction of
# each 384-ray chunk whose stage-1 residual exceeds term_threshold
# re-renders at the full budget. Per path, a threshold and a K that fall in
# wide gaps of the scene's residuals (asserted by _assert_topk_margin):
# (term_threshold, refine_fraction, some rays refine, the top-K cut binds)
ES = dict(early_stop=True, stage1_steps=8, max_ray_batch=384)
ES_PATHS = {"dense_early_stop": (0.5, 1 / 32, True, True),
            "probe_early_stop": (0.1, 1 / 192, True, False),
            "probe_grid_early_stop": (8.5e-4, 1 / 384, True, True)}


def _assert_topk_margin(jm, params, tm, rays, cfg, grid):
    """As tests/test_torch_render.py's: the two sides' stage-1 residuals
    differ by less than half of any residual's distance from the threshold
    and, where more rays are alive than K, of the gap at the K-th; so the
    same rays refine on both sides. Returns (alive rays, chunks cut)."""
    kw = dict(num_steps=cfg["stage1_steps"], upsample_steps=0,
              probe_placement=cfg.get("probe_placement", False),
              num_probe=cfg.get("num_probe", 16),
              occ_candidates=cfg.get("occ_candidates", 128))
    cfg_j = jr.RenderConfig(**kw)
    stage1 = jax.jit(lambda p, o, d, n, g: jr.render_rays(
        jm, {"params": p}, o, d, n, None, cfg_j, g)["semantics"])
    gj, gt = grid
    chunk, th = cfg["max_ray_batch"], cfg["term_threshold"]
    k = max(1, int(round(chunk * cfg["refine_fraction"])))
    n_alive = n_cut = 0
    for s in range(0, rays["rays_o"].shape[0], chunk):
        o, d, n = (rays[name][s:s + chunk] for name in RAYS)
        tj = 1.0 - np.asarray(stage1(params, o.numpy(), d.numpy(), n.numpy(),
                                     gj)).sum(-1)
        tt = 1.0 - tr.render_rays(tm, o, d, n, tr.RenderConfig(**kw),
                                  gt)["semantics"].sum(-1).numpy()
        err = np.abs(tj - tt).max()
        assert np.abs(tj - th).min() > 2 * err
        alive = int((tj > th).sum())
        if alive > k:
            ranked = np.sort(tj)[::-1]
            assert ranked[k - 1] - ranked[k] > 2 * err
            n_cut += 1
        n_alive += alive
    return n_alive, n_cut


@pytest.mark.parametrize("what", ["dense", *ES_PATHS])
def test_render_rays_staged_matches_jax(scene, es_scene, what):
    """render_rays_staged over the 32×40 frame in 384-ray chunks (the last
    one padded): the dense program flat and under early stop, and probe
    placement under early stop (stage 1 keeps it) without and with a
    grid."""
    kw = dict(PROBE if what.startswith("probe") else DENSE,
              max_ray_batch=384)
    if what in ES_PATHS:
        th, frac, refines, cuts = ES_PATHS[what]
        kw.update(ES, term_threshold=th, refine_fraction=frac)
        scene = es_scene
    jm, params, tm, grid, _, rays = scene
    if what.startswith("probe"):
        jm, tm = _exact_probe(params)
    g = _grid(grid, what == "probe_grid_early_stop")
    if what in ES_PATHS:
        n_alive, n_cut = _assert_topk_margin(jm, params, tm, rays, kw, g)
        assert (n_alive > 0) == refines and (n_cut > 0) == cuts
    cfg_j = jr.RenderConfig(**kw)
    jout = jax.jit(lambda p, o, d, n, g: jr.render_rays_staged(
        jm, {"params": p}, o, d, n, cfg_j, g))(
        params, *(rays[k].numpy() for k in RAYS), g[0])
    tout = tr.render_rays_staged(tm, *(rays[k] for k in RAYS),
                                 tr.RenderConfig(**kw), g[1])
    _check(jout, tout)


# ----------------------------------------------------------------- training
TRAIN_H, TRAIN_W = 12, 16
TRAIN_CFG = dict(num_steps=16, upsample_steps=8)


def _jax_draws(key, cfg):
    """The draws of JAX's _step_body for `key`: pixel indices from k_rays,
    the coarse (here the stratified jitter) and fine uniforms from
    k_render's two halves."""
    k_rays, k_render = jax.random.split(key)
    k_coarse, k_fine = jax.random.split(k_render)
    return {"inds": _t(jax.random.randint(k_rays, (N_RAYS,), 0,
                                          TRAIN_H * TRAIN_W)),
            "u_coarse": _t(jax.random.uniform(
                k_coarse, (N_RAYS, cfg.num_steps), jnp.float32)),
            "u_fine": _t(jax.random.uniform(
                k_fine, (N_RAYS, cfg.upsample_steps), jnp.float32))}


def _level_sums(table_grad, spec):
    g = np.asarray(table_grad, np.float64)
    sums, mass = [], []
    for lvl in range(spec.n_levels):
        rows = g[spec.offsets[lvl]:spec.offsets[lvl] + spec.sizes[lvl]]
        sums.append(rows.sum(0))
        mass.append(np.abs(rows).sum())
    return np.stack(sums), np.array(mass)


def _train_batch(rng):
    depth = rng.uniform(0.5, 1.5, (TRAIN_H, TRAIN_W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    label = rng.integers(-1, 6, (TRAIN_H, TRAIN_W)).astype(np.int32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, -0.6]
    return {"pose": pose,
            "intrinsics": np.array([14.0, 14.0, 8.0, 6.0], np.float32),
            "image": rng.uniform(0, 1, (TRAIN_H, TRAIN_W, 3)).astype(
                np.float32),
            "label": label, "depth": depth,
            "one_m_to_scene_uom": np.float32(1.3)}


def test_dense_train_steps_match_jax():
    """Two NeRFTrainer.train_steps without a grid (the stratified coarse
    samples jittered by JAX's k_coarse draw), the port's and the JAX
    trainer's from the same weights and JAX's draws: the second from the
    port's own state carried to JAX (parameters, Adam's moments and
    count), the model at its init (table U(-1e-4, 1e-4)), as
    tests/test_torch_train.py trains it. Per step every loss within 2e-3
    relative and the table gradient's per-level sums within 1e-3 of the
    level's mass."""
    jm = JNeRF(**MODEL_KW)
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.key(1), jnp.zeros((4, 3)),
        jnp.zeros((4, 3)).at[:, 2].set(1.0))["params"])
    cfg_j = jr.RenderConfig(**TRAIN_CFG)
    jt = jnt.NeRFTrainer(jm, cfg_j, lr=1e-2, n_rays=N_RAYS,
                         image_hw=(TRAIN_H, TRAIN_W))
    jt.tx = optax.chain(_stash_grads(), jt.tx)
    _, opt_state = jt.init(jax.random.key(0))
    tt = tnt.NeRFTrainer(SemanticNeRF(**MODEL_KW, device="cpu"),
                         tr.RenderConfig(**TRAIN_CFG), lr=1e-2,
                         n_rays=N_RAYS, image_hw=(TRAIN_H, TRAIN_W),
                         device="cpu")
    tt.init(params_from_jax(params))
    spec = tt.model.encoder.spec
    b = _train_batch(np.random.default_rng(6))
    batch_t = {k: _t(v) for k, v in b.items()}
    from test_torch_train import _jax_state_of
    p_j = params
    for step in range(2):
        if step:
            p_j, opt_state = _jax_state_of(tt, opt_state)
        key = jax.random.key(300 + step)
        p_j, opt_state, parts_j = jt.train_step(p_j, opt_state, b, key,
                                                occ_grid=None)
        parts_t = tt.train_step(batch_t, None, None,
                                draws=_jax_draws(key, cfg_j))
        for k in parts_j:
            a, r = float(parts_t[k]), float(parts_j[k])
            assert np.isfinite(a) and abs(a - r) <= 2e-3 * abs(r), \
                (step, k, a, r)
        sums_j, mass_j = _level_sums(opt_state[0]["encoder"]["table"], spec)
        sums_t, _ = _level_sums(tt.model.encoder.table.grad, spec)
        assert (mass_j > 0).all()
        assert (np.abs(sums_t - sums_j) <= 1e-3 * mass_j[:, None]).all(), \
            (step, np.abs(sums_t - sums_j).max(-1) / mass_j)


def test_exact_refresh_matches_jax(scene):
    """update_occupancy with OccupancyConfig(probe_sampled=False): each
    slab's densities through the exact density (hash_encode + the sigma
    MLP), JAX's jitter replayed, two refreshes from a seeded grid. The
    refreshed slab within 1e-5 relative of JAX's where the probe
    positions reach the encoder with the same bits, the decayed rest
    exact."""
    from test_torch_train import _probe_bits_agree
    jm, params, tm, *_ = scene
    cfg_j = jocc.OccupancyConfig(resolution=OCC_RES, probe_sampled=False)
    cfg_t = tocc.OccupancyConfig(resolution=OCC_RES, probe_sampled=False)
    jt = jnt.NeRFTrainer(jm)
    jt.occ_cfg = cfg_j
    tt = tnt.NeRFTrainer(tm, device="cpu")
    tt.occ_cfg = cfg_t
    jt.init_occupancy()
    tt.init_occupancy()
    grid = np.random.default_rng(5).uniform(0, 2, (OCC_RES,) * 3).astype(
        np.float32)
    cells = OCC_RES ** 3 // 4
    for slab in range(2):
        key = jax.random.key(40 + slab)
        ref = np.asarray(jt.update_occupancy(params, jnp.asarray(grid), key))
        jitter = _t(jax.random.uniform(key, (cells, 3)))
        out = tt.update_occupancy(_t(grid), jitter=jitter).numpy()
        lo, hi = slab * cells, (slab + 1) * cells
        same = _probe_bits_agree(slab, jitter)
        assert same.mean() > 0.3
        o, r = out.reshape(-1), ref.reshape(-1)
        np.testing.assert_allclose(o[lo:hi][same], r[lo:hi][same],
                                   rtol=1e-5)
        rest = np.r_[0:lo, hi:OCC_RES ** 3]
        np.testing.assert_array_equal(o[rest], r[rest])
        grid = out


# ------------------------------------------------------------ JointTrainer
J_H, J_W = 24, 32
J_CFG = dict(num_steps=8, upsample_steps=4, max_ray_batch=512)
DENSE_EXP = {**EXP, "nerf": {**EXP["nerf"], "use_occupancy": False}}


@pytest.fixture(scope="module")
def dense_joint():
    rng = np.random.default_rng(0)
    kw = dict(MODEL_KW, log2_hashmap_size=10)
    jm = JNeRF(**kw, stochastic_table_grad=False)
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    nerf = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), x, d)["params"])
    nerf["encoder"]["table"] = rng.uniform(
        -0.05, 0.05, nerf["encoder"]["table"].shape).astype(np.float32)
    sigma_out = nerf["sigma_net"]["Dense_1"]["kernel"]
    sigma_out[:, 0] = -np.abs(sigma_out[:, 0])
    nerf["semantics_net"]["Dense_1"]["kernel"] *= 50.0
    js = _NoDropout(**SEG_KW)
    seg = jax_weights(js, (1, J_H, J_W, 3), seed=4)
    jt = JJoint(DENSE_EXP, image_hw=(J_H, J_W), num_classes=6,
                render_cfg=jr.RenderConfig(**J_CFG), n_rays=N_RAYS,
                nerf_model=jm, seg_model=js)
    jt.nerf_tx = optax.chain(_stash_grads(), jt.nerf_tx)
    jt.seg_tx = optax.chain(_stash_grads(), jt.seg_tx)
    tt = JointTrainer(DENSE_EXP, image_hw=(J_H, J_W), num_classes=6,
                      render_cfg=tr.RenderConfig(**J_CFG), n_rays=N_RAYS,
                      nerf_model=SemanticNeRF(**kw, device="cpu",
                                              stochastic_table_grad=False),
                      seg_model=DeepLabV3(**SEG_KW, device="cpu"),
                      device="cpu")
    return jt, tt, nerf, seg


def test_dense_joint_trainer_matches_jax(dense_joint):
    """nerf.use_occupancy: false. The derived test and predict configs are
    the train config, field by field as JAX's, and budget_summary reports
    occupancy=False; init_occupancy() and update_occupancy(None) give None
    on both sides; one joint_step (2 new frames, the BN trick, the per-image
    dense NeRF steps, 1 old frame) from the shared start with JAX's draws:
    the logs within 2e-3, the assembled seg step's gradient and stats, and
    the last NeRF step's gradient as tests/test_torch_joint_trainer.py
    holds them."""
    jt, tt, nerf, (sp, ss) = dense_joint
    for name in ("cfg", "test_cfg", "predict_cfg"):
        for f in tr.RenderConfig.__dataclass_fields__:
            assert getattr(getattr(tt, name), f) == \
                getattr(getattr(jt, name), f), (name, f)
    assert tt.test_cfg == tt.predict_cfg == tt.cfg
    assert tt.budget_summary() == jt.budget_summary()
    assert "occupancy=False" in tt.budget_summary()
    assert jt.init_occupancy() is None and tt.init_occupancy() is None
    assert tt.update_occupancy(None) is None
    assert jt.update_occupancy(None, None, jax.random.key(0)) is None

    tt.init(params_from_jax(nerf), deeplab_state_from_jax(sp, ss))
    pin_dropout_off(tt.seg.model)
    nerf_state, seg_state = (nerf, jt.nerf_tx.init(nerf)), \
        (sp, ss, jt.seg_tx.init(sp))
    rng = np.random.default_rng(12)
    new = _new_batch(rng, 2)
    old = {"img": rng.uniform(0, 1, (1, J_H, J_W, 3)).astype(np.float32),
           "nerf_label": rng.integers(0, 6, (1, J_H, J_W)).astype(np.int32)}
    key = jax.random.key(21)
    draws = _joint_draws(key, jt.cfg, 2, False, False)
    nerf_j, seg_j, logs_j = jt.joint_step(nerf_state, seg_state, old, new,
                                          None, key, occ_grid=None)
    logs_t = tt.joint_step(old, new, None, torch.Generator(), None,
                           draws=draws)
    _check_logs(logs_t, logs_j)
    assert "loss_nerf_total" in logs_t
    _check_seg(tt, seg_j, rendered=True)
    _check_nerf(tt, nerf_j, steps=2)


# ---------------------------------------------------------------- seg bf16
SEG_H, SEG_W = 48, 64


@pytest.fixture(scope="module")
def seg_bf16():
    jm = jdl.DeepLabV3(**SMALL, dtype=jnp.bfloat16)
    params, stats = jax_weights(jdl.DeepLabV3(**SMALL), (1, SEG_H, SEG_W, 3),
                                seed=3)
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 1, (2, SEG_H, SEG_W, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (2, SEG_H, SEG_W)).astype(np.int32)
    labels[rng.uniform(size=labels.shape) < 0.3] = -1
    return jm, params, stats, images, labels


# what a bf16 net computes in, as chip_smoke.seg_dtypes records it (an f32
# net, or one that dropped its input cast, shows f32 everywhere)
BF16_SEEN = {"conv": {torch.bfloat16}, "bn": {torch.bfloat16},
             "logits": {torch.float32}}


def test_seg_compute_dtype_reads_the_config():
    """model.compute_dtype as JAX's seg_compute_dtype reads it: absent →
    float32, a dtype name → that dtype; not a floating dtype → raises."""
    assert seg_compute_dtype(None) == torch.float32
    assert seg_compute_dtype({}) == torch.float32
    assert seg_compute_dtype({"compute_dtype": "bfloat16"}) == torch.bfloat16
    assert jdl.seg_compute_dtype({"compute_dtype": "bfloat16"}) == \
        jnp.bfloat16
    assert seg_compute_dtype({"compute_dtype": "float32"}) == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        seg_compute_dtype({"compute_dtype": "int8"})


def _seg_forward(params, stats, images, dtype, ura):
    """(JAX logits, JAX batch stats, port logits, port model, the dtypes
    the port computed in) of one forward at compute dtype `dtype` (a torch
    dtype), BN with running stats (ura) or batch stats, dropout off; the
    port's logits NHWC."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = jdl.DeepLabV3(**SMALL, dtype=jdt)
    with jax.default_matmul_precision("float32"):
        out, mutated = jax.jit(lambda p, s, x: jm.apply(
            {"params": p, "batch_stats": s}, x, use_running_average=ura,
            deterministic=True, mutable=["batch_stats"]))(params, stats,
                                                          images)
    model = DeepLabV3(**SMALL, device="cpu", compute_dtype=dtype)
    model.load_state_dict(deeplab_state_from_jax(params, stats), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.set_mode(ura, True)
    with seg_dtypes(model) as seen, torch.no_grad():
        logits = model(torch.from_numpy(images).permute(0, 3, 1, 2))["out"]
    assert logits.dtype == torch.float32
    return (np.asarray(out["out"]), mutated["batch_stats"],
            logits.numpy().transpose(0, 2, 3, 1), model, seen)


@pytest.mark.parametrize("mode", ["eval", "bn_trick"])
def test_seg_bf16_forward_matches_jax(seg_bf16, mode):
    """DeepLabV3 with compute_dtype bfloat16 against JAX's dtype=bfloat16
    on the same f32 weights (the port loads the f32 state dict as is).
    Both modes: every convolution and BN writes bf16 and the logits reach
    the resize in f32 (an f32 net shows f32 everywhere), and the port's
    bf16 logits lie at least half as far from its f32 ones as JAX's bf16
    from JAX's f32 (a net computing in f32 lies at 0). Eval mode: f32
    logits within 2e-2 of their largest magnitude, argmax labels equal on
    ≥ 0.99 of the pixels. The BN trick (batch statistics) turns the tiny
    net's bf16 rounding into a tenth of the logits: JAX's own bf16 logits
    lie 0.11 from its f32 ones, its labels 0.93 equal; so the port's bf16
    is held to the f32 forward as JAX's is: no further than 1.25× JAX's
    distance, labels no less equal than JAX's less 0.02, and the running
    stats (f32 statistics of the bf16 activations) within 2e-2 relative
    of JAX's."""
    _, params, stats, images, _ = seg_bf16
    ura = mode == "eval"
    lj, stats_j, lt, model, seen = _seg_forward(params, stats, images,
                                                torch.bfloat16, ura)
    lj32, _, lt32, _, seen32 = _seg_forward(params, stats, images,
                                            torch.float32, ura)
    assert seen == BF16_SEEN, seen
    assert seen32 == {k: {torch.float32} for k in seen32}, seen32
    assert rel_err(lt32, lj32) <= 1e-4
    assert rel_err(lt, lt32) >= 0.5 * rel_err(lj, lj32)
    if ura:
        assert rel_err(lt, lj) <= 2e-2
        assert (lt.argmax(-1) == lj.argmax(-1)).mean() >= 0.99
        return
    assert rel_err(lt, lt32) <= 1.25 * rel_err(lj, lj32)
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).mean()
    assert agree(lt, lt32) >= agree(lj, lj32) - 0.02
    ref = deeplab_state_from_jax(params, stats_j)
    state = model.state_dict()
    for k, r in ref.items():
        if "running" in k:
            assert rel_err(state[k].numpy(), r.numpy()) <= 2e-2, k


def test_seg_bf16_r101_labels_as_jax():
    """The full-width DeepLabV3-R101 (40 classes) at a fresh numpy-drawn
    init, eval mode, batch 2 at 96×128: its bf16 forward against its f32
    one, the port's and JAX's. A fresh net's logits sit near ties, so bf16
    moves labels: JAX's own bf16 labels agree with its f32 ones on 0.976
    of the pixels (logits 2.0e-2 of their largest), the port's on 0.976
    (1.8e-2). Held on both sides: the port's agreement within 0.01 of
    JAX's, its logits' distance between 0.5× and 1.25× JAX's (an f32
    forward would agree on all pixels at distance 0; chip_smoke.py's
    phase 13 (d) takes its limits from this), and the bf16 net's
    convolutions and BNs write bf16, its logits reach the resize in
    f32."""
    kw = dict(num_classes=40)
    params, stats = jax_weights(jdl.DeepLabV3(**kw), (1, 96, 128, 3), seed=3)
    images = np.random.default_rng(8).uniform(0, 1, (2, 96, 128, 3)).astype(
        np.float32)
    logits = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = jdl.DeepLabV3(**kw, dtype=jdt)
        with jax.default_matmul_precision("float32"):
            logits["jax", name] = np.asarray(jax.jit(lambda p, s, x: jm.apply(
                {"params": p, "batch_stats": s}, x, use_running_average=True,
                deterministic=True))(params, stats, images)["out"])
        model = DeepLabV3(**kw, device="cpu", compute_dtype=tdt)
        model.load_state_dict(deeplab_state_from_jax(params, stats))
        with seg_dtypes(model) as seen, torch.no_grad():
            logits["port", name] = model.eval()(torch.from_numpy(
                images).permute(0, 3, 1, 2))["out"].numpy().transpose(
                0, 2, 3, 1)
    assert seen == BF16_SEEN, seen
    agree = {side: (logits[side, "bf16"].argmax(-1)
                    == logits[side, "f32"].argmax(-1)).mean()
             for side in ("jax", "port")}
    dist = {side: rel_err(logits[side, "bf16"], logits[side, "f32"])
            for side in ("jax", "port")}
    assert rel_err(logits["port", "f32"], logits["jax", "f32"]) <= 1e-4
    assert abs(agree["port"] - agree["jax"]) <= 0.01, agree
    assert 0.5 * dist["jax"] <= dist["port"] <= 1.25 * dist["jax"], dist


def test_seg_bf16_step_matches_jax(seg_bf16):
    """One SegTrainer step (Adam 1e-4, dropout pinned off) at bf16 compute
    against JAX's bf16 step composed from its cross_entropy_ignore and
    optimizer: the loss within 1e-2 relative, finite parameters, each
    still f32, the step's convolutions and BNs writing bf16 and its
    logits reaching the resize in f32."""
    jm, params, stats, images, labels = seg_bf16

    @jax.jit
    def loss_and_grad(params):
        def loss_fn(p):
            out = jm.apply({"params": p, "batch_stats": stats}, images,
                           use_running_average=False, deterministic=True,
                           mutable=["batch_stats"])[0]
            return jst.cross_entropy_ignore(out["out"], labels)
        return jax.value_and_grad(loss_fn)(params)

    loss_j, _ = loss_and_grad(params)
    trainer = pst.SegTrainer(DeepLabV3(**SMALL, device="cpu",
                                       compute_dtype=torch.bfloat16),
                             {"name": "Adam", "lr": 1e-4}, device="cpu")
    trainer.init(deeplab_state_from_jax(params, stats))
    pin_dropout_off(trainer.model)
    with seg_dtypes(trainer.model) as seen:
        loss_t, conf = trainer.train_step(torch.from_numpy(images),
                                          torch.from_numpy(labels), 1e-4,
                                          torch.Generator())
    assert abs(float(loss_t) - float(loss_j)) <= 1e-2 * abs(float(loss_j))
    assert seen == BF16_SEEN, seen
    assert int(conf.sum()) == int((labels >= 0).sum())
    for p in trainer.model.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()


# ------------------------------------------------------------ the stage CLI
def test_train_joint_cli_runs_the_opt_in_paths(tmp_path, monkeypatch):
    """The port's train_joint CLI (main(argv), --device cpu) on a synthetic
    room of 5 frames of 24×32, 1 + 1 epochs, with
    cfg/exp/one_step_joint/s00_lr1e-5.yml's renderer block replaced by
    8 + 4 samples and probe-placed test and predict renders (8 probes),
    nerf.use_occupancy: false, a tiny Semantic-NeRF from the nerf: block
    and model.compute_dtype: bfloat16 (the loop's default seg net patched
    to a tiny one, which records the dtype it is given): the stage runs
    without a grid (none returned, none in last_ckpt), the test config
    places by probe, the seg net computes in bf16, every logged value is
    finite and each predict folder holds a PNG a frame."""
    import json
    import os

    from chip_smoke import _yaml
    from test_torch_joint_loop import EXP_PATH, SCENE
    from ucsa_neural_rendering_tpu_torch.config import load_yaml
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_scene_dir
    from ucsa_neural_rendering_tpu_torch.scripts import train_joint as cli
    from ucsa_neural_rendering_tpu_torch.train import joint_loop as tloop
    from ucsa_neural_rendering_tpu_torch.train.checkpoints import load_tree

    h, w = 24, 32
    env = {"results": str(tmp_path / "results"),
           "scannet": str(tmp_path / "scans"),
           "scannet_frames_25k": str(tmp_path / "frames25k")}
    write_synthetic_scene_dir(env["scannet"], SCENE, n_frames=5, H=h, W=w,
                              color_ext=".png")
    (tmp_path / "env.yml").write_text(
        "".join(f"{k}: {v}\n" for k, v in env.items()))
    monkeypatch.setenv("ENV_WORKSTATION_NAME", str(tmp_path / "env"))
    exp = load_yaml(EXP_PATH)
    exp["general"].update(name="opt_in", checkpoint_load=None)
    exp["trainer"]["load_from_checkpoint"] = False
    exp["model"].update(num_classes=SEG_KW["num_classes"],
                        compute_dtype="bfloat16")
    exp["output_size"] = [h, w]
    exp["data_module"]["batch_size"] = 2
    exp["val_scenes"] = [SCENE]
    exp["nerf"] = {**exp["nerf"], "use_occupancy": False, "bound": 1.0,
                   "n_levels": 4, "n_features": 2, "log2_hashmap_size": 10,
                   "n_rays": 64}
    exp["renderer"] = {"num_steps": 8, "upsample_steps": 4,
                       "max_ray_batch": 512, "test_probe_placement": True,
                       "test_num_probe": 8}
    exp_path = tmp_path / "exp.yml"
    exp_path.write_text("\n".join(_yaml(exp)) + "\n")
    dtypes = []

    def tiny_seg(num_classes, device, generator, compute_dtype):
        dtypes.append(compute_dtype)
        return DeepLabV3(**SEG_KW, device=device, generator=generator,
                         compute_dtype=compute_dtype)

    monkeypatch.setattr(tloop, "DeepLabV3", tiny_seg)
    trainer, grid = cli.main(["--exp", str(exp_path), "--device", "cpu",
                              "--exp_name", "opt_in", "--nerf_train_epoch",
                              "1", "--joint_train_epoch", "1"])
    assert grid is None and dtypes == [torch.bfloat16]
    assert trainer.seg.model.compute_dtype == torch.bfloat16
    assert not trainer.use_occupancy
    assert trainer.test_cfg.probe_placement and trainer.test_cfg.num_probe \
        == 8 and trainer.predict_cfg == trainer.test_cfg
    assert not trainer.cfg.probe_placement
    run = os.path.join(env["results"], "opt_in")
    assert "occ_grid" not in load_tree(os.path.join(run, "last_ckpt"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(x) for x in f]
    values = [v for r in records for k, v in r.items()
              if k not in ("step", "time")]
    assert values and np.isfinite(values).all()
    n_frames = len(os.listdir(os.path.join(env["scannet"], SCENE,
                                           "color_scaled")))
    for sub in tloop.PREDICT_SUBFOLDERS:
        folder = os.path.join(env["scannet"], SCENE, "opt_in", sub)
        assert len(os.listdir(folder)) == n_frames, sub
