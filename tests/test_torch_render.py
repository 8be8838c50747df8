"""The port's deterministic render against the JAX package's, on the CPU.

One JAX SemanticNeRF(bound=1, C=6, 8 levels × 4 features, 2^15 table) with
its table drawn U(-0.5, 0.5) from numpy is carried across with
params_from_jax, so both sides compute the same function. The density
output's weights (column 0 of the sigma net's last layer) are made
non-positive and 8× wider, so that most of the volume is near-empty as in a
fitted scene and early stop finds unsaturated rays. The occupancy grid is
numpy-seeded. The JAX side runs jitted, as its trainers run it.

Tolerances (outputs are f32; the MLPs run in bf16 on both sides, and an
XLA bf16 matmul and a torch one round an occasional element to the other
neighbour — 1 bf16 ulp, 0.4% of a logit — which the inverse-CDF placement
and the w > 1e-4 mask can lift further on a few rays):
  * image and semantic mass: max |diff| 3e-3, mean |diff| 1e-4;
  * depth (scene units, bound 1, z up to ~3): max |diff| 3e-2, mean |diff|
    1e-3;
  * the semantic argmax of render_image: identical on every pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu.data.rays import get_rays as jget_rays
from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.ops import renderer as jr
from ucsa_neural_rendering_tpu.train.nerf_trainer import \
    NeRFTrainer as JTrainer
from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
from ucsa_neural_rendering_tpu_torch.models import (SemanticNeRF,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.ops import renderer as tr
from ucsa_neural_rendering_tpu_torch.train.nerf_trainer import NeRFTrainer

H, W = 24, 32
MODEL_KW = dict(bound=1.0, num_semantic_classes=6, n_levels=8, n_features=4,
                log2_hashmap_size=15)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    jm = JNeRF(**MODEL_KW)
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), x, d)["params"])
    params["encoder"]["table"] = rng.uniform(
        -0.5, 0.5, params["encoder"]["table"].shape).astype(np.float32)
    sigma_out = params["sigma_net"]["Dense_1"]["kernel"]
    sigma_out[:, 0] = -8.0 * np.abs(sigma_out[:, 0])
    tm = SemanticNeRF(**MODEL_KW, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    r = 32
    grid = np.where(rng.uniform(size=(r, r, r)) > 0.6,
                    rng.uniform(0.0, 20.0, (r, r, r)), 1e-3
                    ).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, -0.6]
    intr = np.array([30.0, 30.0, 16.0, 12.0], np.float32)
    return jm, params, tm, grid, pose, intr


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


def test_get_rays_matches_jax(scene):
    *_, pose, intr = scene
    jrays = jget_rays(jnp.asarray(pose), jnp.asarray(intr), H, W)
    trays = get_rays(pose, intr, H, W, device="cpu")
    for k in ("rays_o", "rays_d", "direction_norms"):
        np.testing.assert_allclose(trays[k].numpy(), np.asarray(jrays[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("proposal", [False, True])
def test_render_rays_matches_jax(scene, proposal):
    """render_rays with occupancy placement (binary or proposal), 16 coarse
    + 16 fine samples, against jr.render_rays on the same 256 rays."""
    jm, params, tm, grid, pose, intr = scene
    rays = get_rays(pose, intr, H, W, device="cpu")
    ro, rd, dn = (rays[k][:256] for k in ("rays_o", "rays_d",
                                           "direction_norms"))
    cfg_t = tr.RenderConfig(num_steps=16, upsample_steps=16,
                            proposal_placement=proposal)
    cfg_j = jr.RenderConfig(num_steps=16, upsample_steps=16,
                            proposal_placement=proposal)
    jout = jax.jit(lambda p, o, d, n, g: jr.render_rays(
        jm, {"params": p}, o, d, n, None, cfg_j, g))(
        params, ro.numpy(), rd.numpy(), dn.numpy(), grid)
    tout = tr.render_rays(tm, ro, rd, dn, cfg_t, torch.from_numpy(grid))
    _check(jout, tout)


# early stop: 8 stage-1 samples, then 16 + 16 on the top 1/64 of each chunk
# whose residual exceeds 4e-5 — a threshold and a K that fall in wide gaps
# of this scene's residuals (asserted by _assert_topk_margin), with some
# chunks holding more unsaturated rays than K, so the top-K cut is tested
ES = dict(num_steps=16, upsample_steps=16, early_stop=True, stage1_steps=8,
          refine_fraction=1 / 64, term_threshold=4e-5, max_ray_batch=256)


def _assert_topk_margin(jm, params, tm, rays, grid, es):
    """Early stop refines, per chunk, the top-K rays by stage-1 residual
    t_rem and keeps the refined result where t_rem > term_threshold
    ("alive"). Assert that the two sides' stage-1 t_rem differ by less than
    half the distance of any t_rem from the threshold and, where more than
    K rays are alive, less than half the gap between the K-th and (K+1)-th
    t_rem: then the same rays refine on both sides, whatever the order of
    ties among the rest. Returns (alive rays, chunks where K cut them)."""
    kw = dict(num_steps=es["stage1_steps"], upsample_steps=0,
              proposal_placement=es.get("proposal_placement", False))
    cfg_j = jr.RenderConfig(**kw)
    stage1 = jax.jit(lambda p, o, d, n, g: jr.render_rays(
        jm, {"params": p}, o, d, n, None, cfg_j, g)["semantics"])
    chunk, th = es["max_ray_batch"], es["term_threshold"]
    k = max(1, int(round(chunk * es["refine_fraction"])))
    n_alive = n_cut = 0
    for s in range(0, rays["rays_o"].shape[0], chunk):
        o, d, n = (rays[name][s:s + chunk] for name in
                   ("rays_o", "rays_d", "direction_norms"))
        tj = 1.0 - np.asarray(stage1(params, o.numpy(), d.numpy(), n.numpy(),
                                     grid)).sum(-1)
        tt = 1.0 - tr.render_rays(tm, o, d, n, tr.RenderConfig(**kw),
                                  torch.from_numpy(grid)
                                  )["semantics"].sum(-1).numpy()
        err = np.abs(tj - tt).max()
        assert np.abs(tj - th).min() > 2 * err
        alive = int((tj > th).sum())
        if alive > k:
            ranked = np.sort(tj)[::-1]
            assert ranked[k - 1] - ranked[k] > 2 * err
            n_cut += 1
        n_alive += alive
    return n_alive, n_cut


def test_render_rays_staged_early_stop_matches_jax(scene):
    """render_rays_staged with early stop over a 24×32 frame in 256-ray
    chunks."""
    jm, params, tm, grid, pose, intr = scene
    rays = get_rays(pose, intr, H, W, device="cpu")
    n_alive, n_cut = _assert_topk_margin(jm, params, tm, rays, grid, ES)
    assert n_alive > 0 and n_cut > 0  # refinement and the top-K cut run
    cfg_j = jr.RenderConfig(**ES)
    jout = jax.jit(lambda p, o, d, n, g: jr.render_rays_staged(
        jm, {"params": p}, o, d, n, cfg_j, g))(
        params, *(rays[k].numpy() for k in ("rays_o", "rays_d",
                                             "direction_norms")), grid)
    tout = tr.render_rays_staged(tm, rays["rays_o"], rays["rays_d"],
                                 rays["direction_norms"],
                                 tr.RenderConfig(**ES), torch.from_numpy(grid))
    _check(jout, tout)


def test_render_image_matches_jax(scene):
    """NeRFTrainer.render_image end to end (proposal placement, early stop,
    a padded last chunk: 768 rays in 320-ray chunks) against the JAX
    trainer's: the five outputs within the stated tolerances and the
    semantic argmax identical on every pixel."""
    jm, params, tm, grid, pose, intr = scene
    es = dict(ES, max_ray_batch=320, proposal_placement=True)
    trays = get_rays(pose, intr, H, W, device="cpu")
    assert _assert_topk_margin(jm, params, tm, trays, grid, es)[0] > 0
    jt = JTrainer(jm, jr.RenderConfig(**es), image_hw=(H, W))
    jrays = jget_rays(jnp.asarray(pose), jnp.asarray(intr), H, W)
    jout = jt.render_image(params, jnp.asarray(pose), jnp.asarray(intr),
                           jrays, jnp.asarray(grid))
    tt = NeRFTrainer(SemanticNeRF(**MODEL_KW, device="cpu"),
                     tr.RenderConfig(**es), image_hw=(H, W), device="cpu")
    tout = tt.render_image(params_from_jax(params), pose, intr, trays,
                           torch.from_numpy(grid))
    assert set(tout) == set(jout)
    _close(jout["nerf_rgb"], tout["nerf_rgb"].numpy(), 3e-3, 1e-4)
    _close(jout["nerf_semantics_raw"], tout["nerf_semantics_raw"].numpy(),
           3e-3, 1e-4)
    _close(jout["nerf_depth"], tout["nerf_depth"].numpy(), 3e-2, 1e-3)
    np.testing.assert_array_equal(tout["nerf_semantics"].numpy(),
                                  np.asarray(jout["nerf_semantics"]))
    np.testing.assert_array_equal(tout["nerf_invalid"].numpy(),
                                  np.asarray(jout["nerf_invalid"]))
    assert tout["nerf_rgb"].shape == (H, W, 3)
    assert tout["nerf_semantics_raw"].shape == (H, W, 6)


def test_normalize_semantics_matches_jax():
    rng = np.random.default_rng(3)
    sem = rng.uniform(0, 1, (32, 6)).astype(np.float32)
    sem[:4] = 0.0
    js, ji = jr.normalize_semantics(jnp.asarray(sem))
    ts, ti = tr.normalize_semantics(torch.from_numpy(sem))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
