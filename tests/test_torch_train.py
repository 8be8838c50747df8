"""The port's training slice against the JAX package's, on the CPU: the
activation's gradient, the occupancy refresh, the losses, Adam, and
NeRFTrainer.train_step + update_occupancy as a whole with JAX's random
draws injected.

One JAX SemanticNeRF(bound=1, C=6, 4 levels × 2 features, 2^12 table) is
carried across with params_from_jax, so both sides start from the same
weights; Adam's moments start at zero on both sides. The JAX side runs
jitted, as its trainer does.

Tolerances (the MLPs run in bf16 on both sides, and an XLA bf16 matmul and
a torch one round an occasional element to the other neighbour):
  * trunc_exp's gradient: rtol 1e-6 (the same f32 exp);
  * update_grid: rtol 1e-2 on the refreshed slab (sigma = exp of a bf16
    logit, so 1 bf16 ulp of the logit is ~0.4 % of sigma), exact elsewhere;
  * nerf_losses: rtol 1e-6;
  * Adam: rtol 1e-6, atol 1e-7 = 1e-5 of the step size lr (the same
    update; torch folds the bias corrections into the step size and the
    denominator, optax into the moments, so the roundings differ);
  * the slice: see test_train_steps_and_refresh_match_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ucsa_neural_rendering_tpu.data import rays as jrays
from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.models import activation as jact
from ucsa_neural_rendering_tpu.ops import occupancy as jocc
from ucsa_neural_rendering_tpu.ops import renderer as jr
from ucsa_neural_rendering_tpu.train import nerf_trainer as jnt
from ucsa_neural_rendering_tpu_torch.data.rays import get_rays_sampled
from ucsa_neural_rendering_tpu_torch.models import (SemanticNeRF,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.models.convert import params_to_jax
from ucsa_neural_rendering_tpu_torch.models.activation import trunc_exp
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import renderer as tr
from ucsa_neural_rendering_tpu_torch.train import nerf_trainer as tnt

H, W = 12, 16
N_RAYS = 64
MODEL_KW = dict(bound=1.0, num_semantic_classes=6, n_levels=4, n_features=2,
                log2_hashmap_size=12)
CFG_KW = dict(num_steps=8, upsample_steps=4, proposal_placement=True)
OCC_RES = 16


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_model():
    jm = JNeRF(**MODEL_KW)
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), x, d)["params"])
    return jm, params


def _batch(rng):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.1, -0.7]
    label = rng.integers(-1, 6, (H, W)).astype(np.int32)
    depth = rng.uniform(0.5, 1.5, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0.0
    return {"pose": pose,
            "intrinsics": np.array([14.0, 14.0, W / 2, H / 2], np.float32),
            "image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
            "label": label, "depth": depth,
            "one_m_to_scene_uom": np.float32(1.0)}


def test_trunc_exp_gradient_matches_jax():
    x = np.linspace(-30, 30, 601, dtype=np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    ref = np.asarray(jax.vjp(jact.trunc_exp, x)[1](g)[0])
    xt = _t(x).requires_grad_()
    out = trunc_exp(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.exp(x), rtol=1e-6)
    out.backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-6)
    assert np.isfinite(xt.grad.numpy()).all()
    # bf16 in: the cotangent reaches the input as bf16, as in JAX
    xb = _t(x).to(torch.bfloat16).requires_grad_()
    trunc_exp(xb).sum().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_get_rays_sampled_matches_jax():
    rng = np.random.default_rng(1)
    b = _batch(rng)
    key = jax.random.key(2)
    jo, jd, jn, ji = jax.jit(lambda p, i, k: jrays.get_rays_sampled(
        p, i, H, W, k, N_RAYS))(b["pose"], b["intrinsics"], key)
    to, td, tn, ti = get_rays_sampled(b["pose"], b["intrinsics"], H, W,
                                      inds=_t(ji), device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for a, r in ((to, jo), (td, jd), (tn, jn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    gen = torch.Generator().manual_seed(0)
    *_, inds = get_rays_sampled(b["pose"], b["intrinsics"], H, W, 4096,
                                generator=gen, device="cpu")
    assert inds.min() >= 0 and inds.max() < H * W


def _probe_bits_agree(slab, jitter):
    """Per probed cell of `slab`: whether its probe position reaches the
    encoder with the same f32 bits on both sides. Inside its jitted
    update_grid, XLA folds the constants of (((c + j) / r · 2b − b) + b) / 2b
    and skips the rounding of − b + b, which the port does (in IEEE order,
    as written); a position whose bits differ draws another corner."""
    r, b = OCC_RES, 1.0
    cells = r ** 3 // 4
    flat = torch.arange(slab * cells, (slab + 1) * cells)
    c = torch.stack([flat // (r * r), (flat // r) % r, flat % r], -1).float()
    x01_t = (((c + jitter) / r * (2.0 * b) - b) + b) / (2.0 * b)
    x01_j = jax.jit(lambda c, j: (((c + j) / r * (2.0 * b) - b) + b)
                    / (2.0 * b))(c.numpy(), jitter.numpy())
    return (x01_t.numpy() == np.asarray(x01_j)).all(-1)


def _check_refresh(out, ref, grid_in, slab, jitter):
    """The refreshed slab within rtol 1e-2 where the probe positions agree
    bit for bit (sigma = exp of a bf16 logit, 1 bf16 ulp of which is ~0.4 %
    of sigma), finite and at least the decayed grid elsewhere; every other
    cell exact (decay only)."""
    cells = OCC_RES ** 3 // 4
    lo, hi = slab * cells, (slab + 1) * cells
    out, ref = out.reshape(-1), np.asarray(ref).reshape(-1)
    same = _probe_bits_agree(slab, jitter)
    assert same.mean() > 0.3
    np.testing.assert_allclose(out[lo:hi][same], ref[lo:hi][same], rtol=1e-2)
    decayed = np.float32(0.62) * np.asarray(grid_in).reshape(-1)
    assert np.isfinite(out).all() and (out[lo:hi] >= decayed[lo:hi]).all()
    rest = np.r_[0:lo, hi:OCC_RES ** 3]
    np.testing.assert_array_equal(out[rest], ref[rest])
    np.testing.assert_array_equal(out[rest], decayed[rest])


@pytest.mark.parametrize("slab", range(4))
def test_update_grid_matches_jax(jax_model, slab):
    """One refresh of each of the 4 x-slabs with the sampled-corner probe,
    JAX's jitter injected, the table U(-0.5, 0.5) so that the corner drawn
    matters."""
    jm, params = jax_model
    params = dict(params, encoder={"table": np.random.default_rng(
        20 + slab).uniform(-0.5, 0.5, params["encoder"]["table"].shape
                           ).astype(np.float32)})
    tm = SemanticNeRF(**MODEL_KW, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    cfg_j = jocc.OccupancyConfig(resolution=OCC_RES)
    cfg_t = tocc.OccupancyConfig(resolution=OCC_RES)
    grid = np.random.default_rng(3 + slab).uniform(
        0, 2, (OCC_RES,) * 3).astype(np.float32)
    key = jax.random.key(10 + slab)
    ref = jax.jit(lambda g, k: jocc.update_grid(
        g, lambda x: jm.apply({"params": params}, x,
                              method="density_probe"),
        1.0, k, cfg_j, slab_index=slab))(grid, key)
    jitter = _t(jax.random.uniform(key, (OCC_RES ** 3 // 4, 3)))
    with torch.no_grad():
        out = tocc.update_grid(_t(grid), tm.density_probe, 1.0, cfg=cfg_t,
                               slab_index=slab, jitter=jitter).numpy()
    _check_refresh(out, ref, grid, slab, jitter)


@pytest.mark.parametrize("degenerate", [False, True])
def test_nerf_losses_match_jax(degenerate):
    """The three losses; degenerate = every label -1 and every depth 0 (the
    semantics loss is 0 over all rays, the depth loss divides by 1)."""
    rng = np.random.default_rng(4)
    n, c = 128, 6
    out = {"image": rng.uniform(0, 1, (n, 3)).astype(np.float32),
           "semantics": rng.uniform(0, 1, (n, c)).astype(np.float32),
           "depth": rng.uniform(0, 3, n).astype(np.float32)}
    out["semantics"][:5] = 0.0  # no mass: invalid rays
    gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    labels = rng.integers(-1, c, n).astype(np.int32)
    depth = rng.uniform(0.5, 2, n).astype(np.float32)
    depth[::3] = 0.0
    if degenerate:
        labels[:] = -1
        depth[:] = 0.0
    jt, jp = jnt.nerf_losses(out, gt, labels, depth, np.float32(1.5), c)
    tt, tp = tnt.nerf_losses({k: _t(v) for k, v in out.items()}, _t(gt),
                             _t(labels), _t(depth), 1.5, c)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)
    if degenerate:
        assert tp["loss_nerf_semantics"] == 0 and tp["loss_depth"] == 0


def test_adam_step_matches_optax(jax_model):
    """make_nerf_optimizer against the JAX package's optax chain: two
    steps from zero moments, decay on the MLPs only."""
    jm, params = jax_model
    tm = SemanticNeRF(**MODEL_KW, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    tx = jnt.make_nerf_optimizer(1e-2)
    opt = tnt.make_nerf_optimizer(tm, 1e-2)
    state = tx.init(params)
    rng = np.random.default_rng(5)
    p = params
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-3, p)
        grads["encoder"]["table"][::3] = 0.0  # rows no point touched
        upd, state = tx.update(grads, state, p)
        p = optax.apply_updates(p, upd)
        for name, g in params_from_jax(grads).items():
            tm.get_parameter(name).grad = g
        opt.step()
    for name, ref in params_from_jax(p).items():
        torch.testing.assert_close(tm.get_parameter(name).detach(), ref,
                                   rtol=1e-6, atol=1e-7)


def _level_sums(table_grad, spec):
    """Per-level [L, F] sums of a table gradient and the level's L1 mass."""
    g = np.asarray(table_grad, np.float64)
    sums, mass = [], []
    for lvl in range(spec.n_levels):
        rows = g[spec.offsets[lvl]:spec.offsets[lvl] + spec.sizes[lvl]]
        sums.append(rows.sum(0))
        mass.append(np.abs(rows).sum())
    return np.stack(sums), np.array(mass)


def _stash_grads():
    """An optax stage that passes the gradients through and keeps them as
    its state, so that the JAX trainer's own step reports them."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (g, g))


def _jax_draws(key, cfg):
    """The draws of JAX's _step_body for `key`, split as it splits them:
    pixel indices from k_rays, the coarse and fine uniforms from k_render's
    two halves."""
    k_rays, k_render = jax.random.split(key)
    k_coarse, k_fine = jax.random.split(k_render)
    return {"inds": _t(jax.random.randint(k_rays, (N_RAYS,), 0, H * W)),
            "u_coarse": _t(jax.random.uniform(
                k_coarse, (N_RAYS, cfg.num_steps), jnp.float32)),
            "u_fine": _t(jax.random.uniform(
                k_fine, (N_RAYS, cfg.upsample_steps), jnp.float32))}


def _jax_state_of(tt, opt_state):
    """The port trainer's parameters and Adam state as the JAX trainer's
    (params, opt_state): the moments and the step count carried across."""
    named = dict(tt.model.named_parameters())
    adam = {name: tt.optimizer.state[p] for name, p in named.items()}
    moments = [params_to_jax({n: s[k] for n, s in adam.items()})
               for k in ("exp_avg", "exp_avg_sq")]
    count = int(adam["encoder.table"]["step"])
    masked, adam_j, scale = opt_state[1]
    adam_j = adam_j._replace(count=jnp.int32(count), mu=moments[0],
                             nu=moments[1])
    return params_to_jax(named), (opt_state[0], (masked, adam_j, scale))


def test_train_steps_and_refresh_match_jax(jax_model):
    """3 NeRFTrainer.train_steps with an update_occupancy between steps 2
    and 3, the port's trainer and the JAX package's from the same weights
    and an all-ones 16³ grid, JAX's draws injected into the port.

    A one-ulp difference in a sample position draws another corner, and
    nearly every position differs in its last bits between the two sides
    (the placements' inverse CDFs sum in other orders), so after one step
    the two tables differ by ±lr on different rows. So the JAX trainer runs
    twice: free from the shared start, and, before each step, from the
    port's own state (parameters, Adam moments and count, grid). Per step:
      * every loss of the free run within rtol 5e-3 of the port's;
      * every loss of the resynced step within rtol 1e-3 (bf16 MLPs; the
        placements' summation order);
      * per level and feature, the sum of the table gradient within 1e-3 of
        the level's L1 gradient mass (the stochastic scatter puts each
        (point, level) cotangent whole on one corner, so a level's sum does
        not depend on which corner was drawn);
      * the MLP weights after Adam: within 1e-7 after the first step, whose
        update is lr·g/(|g| + 1e-15) from zero moments, the same on both
        sides wherever g has the same sign; after later steps, max |Δ|
        ≤ 0.25·lr and mean |Δ| ≤ 0.005·lr: an Adam update divides the first
        moment by the root of the second, and a bf16 gradient element one
        ulp (0.4 %) apart moves a weight whose moments nearly cancel by up
        to a tenth of lr (measured ≤ 0.15·lr and ≤ 0.0023·lr);
    and the refresh, from the same state, as in test_update_grid_matches_jax.
    Measured here: losses within 2.5e-4 (free) and 1e-4 (resynced)
    relative, level sums within 3.3e-4 of the mass at the first step.
    """
    jm, params = jax_model
    cfg_j = jr.RenderConfig(**CFG_KW)
    cfg_t = tr.RenderConfig(**CFG_KW)
    jt = jnt.NeRFTrainer(jm, cfg_j, lr=1e-2, n_rays=N_RAYS, image_hw=(H, W))
    jt.tx = optax.chain(_stash_grads(), jt.tx)
    jt.occ_cfg = jocc.OccupancyConfig(resolution=OCC_RES)
    # the JAX trainer donates its params and optimizer state: one each
    _, free_state = jt.init(jax.random.key(0))
    _, opt_state = jt.init(jax.random.key(0))
    free_params, free_grid = params, jt.init_occupancy()

    tt = tnt.NeRFTrainer(SemanticNeRF(**MODEL_KW, device="cpu"), cfg_t,
                         lr=1e-2, n_rays=N_RAYS, image_hw=(H, W),
                         device="cpu")
    tt.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES)
    tt.init(params_from_jax(params))
    grid_t = tt.init_occupancy()
    spec = tt.model.encoder.spec

    b = _batch(np.random.default_rng(6))
    batch_t = {k: _t(v) for k, v in b.items()}
    for step in range(3):
        if step:
            p_j, opt_state = _jax_state_of(tt, opt_state)
        else:
            p_j = params
        if step == 2:
            key = jax.random.key(50)
            jitter = _t(jax.random.uniform(key, (OCC_RES ** 3 // 4, 3)))
            grid_in = grid_t.numpy()
            grid_j = jt.update_occupancy(p_j, grid_in, key)
            jt._occ_slab = 0
            free_grid = jt.update_occupancy(free_params, free_grid, key)
            grid_t = tt.update_occupancy(grid_t, jitter=jitter)
            _check_refresh(grid_t.numpy(), grid_j, grid_in, 0, jitter)
        key = jax.random.key(100 + step)
        p_j, opt_state, parts_j = jt.train_step(p_j, opt_state, b, key,
                                                occ_grid=grid_t.numpy())
        free_params, free_state, parts_free = jt.train_step(
            free_params, free_state, b, key, occ_grid=free_grid)
        parts_t = tt.train_step(batch_t, None, grid_t,
                                draws=_jax_draws(key, cfg_j))
        for k in parts_j:
            a = float(parts_t[k])
            assert np.isfinite(a), (step, k)
            assert abs(a - float(parts_j[k])) <= 1e-3 * abs(parts_j[k]), \
                (step, k, a, float(parts_j[k]))
            assert abs(a - float(parts_free[k])) <= \
                5e-3 * abs(parts_free[k]), (step, k, a, float(parts_free[k]))
        sums_j, mass_j = _level_sums(opt_state[0]["encoder"]["table"], spec)
        sums_t, _ = _level_sums(tt.model.encoder.table.grad, spec)
        assert (mass_j > 0).all()
        assert (np.abs(sums_t - sums_j) <= 1e-3 * mass_j[:, None]).all(), \
            (step, np.abs(sums_t - sums_j).max(-1) / mass_j)
        for name, ref in params_from_jax(p_j).items():
            if name != "encoder.table":
                d = (tt.model.get_parameter(name).detach() - ref).abs()
                if step == 0:
                    assert d.max() <= 1e-7, (step, name)
                else:
                    assert d.max() <= 2.5e-3 and d.mean() <= 5e-5, (step, name)


def test_train_step_at_the_default_render_config_matches_jax(jax_model):
    """One train_step at the trainer's default RenderConfig(), 256 coarse +
    256 fine samples a ray (the backward composites all 512), against the
    JAX trainer's from the same weights, an all-ones 16³ grid and JAX's
    draws: every loss within rtol 1e-3 and, per level and feature, the sum
    of the table gradient within 1e-3 of the level's L1 gradient mass, as
    the resynced steps of test_train_steps_and_refresh_match_jax."""
    jm, params = jax_model
    jt = jnt.NeRFTrainer(jm, lr=1e-2, n_rays=N_RAYS, image_hw=(H, W))
    jt.tx = optax.chain(_stash_grads(), jt.tx)
    jt.occ_cfg = jocc.OccupancyConfig(resolution=OCC_RES)
    _, opt_state = jt.init(jax.random.key(0))
    tt = tnt.NeRFTrainer(SemanticNeRF(**MODEL_KW, device="cpu"), lr=1e-2,
                         n_rays=N_RAYS, image_hw=(H, W), device="cpu")
    assert (tt.cfg.num_steps, tt.cfg.upsample_steps) == (256, 256)
    tt.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES)
    tt.init(params_from_jax(params))
    grid_t = tt.init_occupancy()
    spec = tt.model.encoder.spec

    b = _batch(np.random.default_rng(7))
    key = jax.random.key(200)
    _, opt_state, parts_j = jt.train_step(params, opt_state, b, key,
                                          occ_grid=grid_t.numpy())
    parts_t = tt.train_step({k: _t(v) for k, v in b.items()}, None, grid_t,
                            draws=_jax_draws(key, jt.cfg))
    for k in parts_j:
        a = float(parts_t[k])
        assert np.isfinite(a), k
        assert abs(a - float(parts_j[k])) <= 1e-3 * abs(parts_j[k]), \
            (k, a, float(parts_j[k]))
    sums_j, mass_j = _level_sums(opt_state[0]["encoder"]["table"], spec)
    sums_t, _ = _level_sums(tt.model.encoder.table.grad, spec)
    assert (mass_j > 0).all()
    assert (np.abs(sums_t - sums_j) <= 1e-3 * mass_j[:, None]).all(), \
        np.abs(sums_t - sums_j).max(-1) / mass_j
