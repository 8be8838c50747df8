"""The port's JointTrainer against the JAX package's, on the CPU.

Both sides start from one set of weights: a tiny Semantic-NeRF (bound 1,
6 classes, 4 levels × 2 features, 2^10 table drawn U(-0.05, 0.05), the
density output made non-positive so that most of the volume is
near-empty, the semantic logits 50× wider so that labels are decisive, as
in a fitted scene) carried by params_from_jax, and DeepLabV3 at
TINY_LAYOUT and narrow widths (test_torch_seg.SMALL, 6 classes) drawn
with numpy and carried by deeplab_state_from_jax, at 24×32, with
init_occupancy's all-ones grid and the shipped config's lr_seg 1e-5 and
lr_nerf 1e-2. The NeRF uses the exact table gradient
(stochastic_table_grad=False) except in the stochastic case. Dropout is
pinned off on both sides (the JAX seg model is applied with
deterministic=True everywhere, the port's dropout runs at rate 0), as in
tests/test_torch_seg_trainer.py. JAX's random draws (ray indices, the
inverse-CDF uniforms, the augmentation's parameters, the refresh jitter)
are replayed into the port from JAX's own key splits. The JAX trainer runs
its separate-dispatch joint step (`fused_joint_step: false`), which its
own tests hold bit-equal to the fused one and which compiles once for all
compositions; its optimizers pass through a stage that keeps the
gradients, so that they can be compared.

Tolerances:
  * every loss within 2e-3 relative (PERF.md §2);
  * renders as tests/test_torch_render.py holds them (rgb and semantic
    mass max |Δ| 3e-3, mean 1e-4; depth 3e-2, 1e-3); argmax labels equal
    wherever JAX's two most probable classes are further apart than twice
    the largest probability difference, on ≥ 99 % of the pixels;
  * pseudo-labels (eval mode, identical inputs) equal on every pixel;
  * the joint step's assembled seg batch against JAX's render, augment and
    replay: images max |Δ| 3e-3 and mean 1e-4, labels ≥ 99 % equal;
  * the seg net's running stats within 1e-4 relative of their largest
    magnitude and its step's gradient within 1e-4 of its norm when the seg
    inputs are the same; 1e-3 and 0.25 when they hold renders (see
    _check_seg);
  * the NeRF's last-step gradient within 2e-2 of each tensor's norm and
    its level sums within 5e-3 of the level's mass after one step (at
    most 1 % of the elements moved the other way), 1e-1 and 1e-2 after
    two (see _check_nerf);
  * the refreshed grid within 5e-2 relative where the probe positions
    agree bit for bit, the rest exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_augmentation import jax_params, stack
from test_torch_seg import SMALL, jax_weights, pin_dropout_off, rel_err
from test_torch_train import _probe_bits_agree
from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.models import deeplabv3 as jdl
from ucsa_neural_rendering_tpu.ops import occupancy as jocc
from ucsa_neural_rendering_tpu.ops import renderer as jr
from ucsa_neural_rendering_tpu.train.joint_trainer import \
    JointTrainer as JJoint
from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3, SemanticNeRF,
                                                    deeplab_state_from_jax,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.ops import occupancy as tocc
from ucsa_neural_rendering_tpu_torch.ops import renderer as tr
from ucsa_neural_rendering_tpu_torch.train.joint_trainer import JointTrainer

H, W = 24, 32
C = 6
N_RAYS = 64
OCC_RES = 16
UPDATE_EVERY = 3
MODEL_KW = dict(bound=1.0, num_semantic_classes=C, n_levels=4, n_features=2,
                log2_hashmap_size=10)
SEG_KW = dict(SMALL, num_classes=C)
CFG_KW = dict(num_steps=8, upsample_steps=4, proposal_placement=True,
              max_ray_batch=512, occ_candidates=16)
EXP = {"optimizer": {"lr_seg": 1e-5, "lr_nerf": 1e-2, "name": "Adam"},
       "nerf": {"fused_joint_step": False}}
INTRINSICS = np.array([28.0, 28.0, W / 2, H / 2], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


class _NoDropout(jdl.DeepLabV3):
    """The JAX DeepLabV3 with its dropout pinned off in every mode."""

    def __call__(self, x, use_running_average=True, deterministic=True):
        return super().__call__(x, use_running_average, True)


def _pose(k):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1 * k, -0.1, -0.7 + 0.05 * k]
    return pose


def _new_batch(rng, n, first=0):
    depth = rng.uniform(0.5, 1.5, (n, H, W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    return {"img": rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32),
            "depth": depth,
            "pose": np.stack([_pose(first + k) for k in range(n)]),
            "intrinsics": np.stack([INTRINSICS] * n),
            "one_m_to_scene_uom": rng.uniform(0.8, 1.2, n).astype(np.float32)}


def _labels(rng, shape):
    lab = rng.integers(0, C, shape).astype(np.int32)
    lab[rng.uniform(size=shape) < 0.2] = -1
    return lab


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jm = JNeRF(**MODEL_KW, stochastic_table_grad=False)
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    nerf = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), x, d)["params"])
    nerf["encoder"]["table"] = rng.uniform(
        -0.05, 0.05, nerf["encoder"]["table"].shape).astype(np.float32)
    sigma_out = nerf["sigma_net"]["Dense_1"]["kernel"]
    sigma_out[:, 0] = -np.abs(sigma_out[:, 0])
    # semantic logits 50× wider: decisive labels, as in a fitted scene
    nerf["semantics_net"]["Dense_1"]["kernel"] *= 50.0
    js = _NoDropout(**SEG_KW)
    seg = jax_weights(js, (1, H, W, 3), seed=4)
    grid = np.ones((OCC_RES,) * 3, np.float32)  # init_occupancy's

    jt = JJoint(EXP, image_hw=(H, W), num_classes=C,
                render_cfg=jr.RenderConfig(**CFG_KW), n_rays=N_RAYS,
                nerf_model=jm, seg_model=js)
    jt.nerf_tx = optax.chain(_stash_grads(), jt.nerf_tx)
    jt.seg_tx = optax.chain(_stash_grads(), jt.seg_tx)
    jt.occ_cfg = jocc.OccupancyConfig(resolution=OCC_RES,
                                      update_every=UPDATE_EVERY)
    tt = JointTrainer(EXP, image_hw=(H, W), num_classes=C,
                      render_cfg=tr.RenderConfig(**CFG_KW), n_rays=N_RAYS,
                      nerf_model=SemanticNeRF(**MODEL_KW, device="cpu",
                                              stochastic_table_grad=False),
                      seg_model=DeepLabV3(**SEG_KW, device="cpu"),
                      device="cpu")
    tt.nerf.occ_cfg = tocc.OccupancyConfig(resolution=OCC_RES,
                                           update_every=UPDATE_EVERY)
    return jt, tt, nerf, seg, grid


def _stash_grads():
    """An optax stage that passes the gradients through and keeps them as
    its state, so that the JAX trainer's own step reports them."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (g, g))


def _start(setup, fix_nerf=False, fuse=False, stochastic=False):
    """Both trainers at the shared start: (JAX nerf_state, seg_state), the
    port re-initialised, the flags set on both."""
    jt, tt, nerf, (sp, ss), _ = setup
    jt.fix_nerf = tt.fix_nerf = fix_nerf
    jt.fused_image_step = tt.fuse_images = fuse
    tt.nerf.model.encoder.stochastic_grad = stochastic
    tt.init(params_from_jax(nerf), deeplab_state_from_jax(sp, ss))
    pin_dropout_off(tt.seg.model)
    return (nerf, jt.nerf_tx.init(nerf)), (sp, ss, jt.seg_tx.init(sp))


# ------------------------------------------------------------ JAX's draws
def _image_draws(key, cfg, n=1):
    """_nerf_update_image_impl's draws for `key`: pixel indices from
    k_rays, the coarse and fine uniforms from k_render's two halves."""
    k_rays, k_render = jax.random.split(key)
    return _render_draws(k_render, cfg,
                         _t(jax.random.randint(k_rays, (N_RAYS,), 0, H * W)))


def _render_draws(k_render, cfg, inds):
    k_coarse, k_fine = jax.random.split(k_render)
    n = inds.shape[0]
    return {"inds": inds,
            "u_coarse": _t(jax.random.uniform(k_coarse, (n, cfg.num_steps))),
            "u_fine": _t(jax.random.uniform(k_fine,
                                            (n, cfg.upsample_steps)))}


def _nerf_draws(key, cfg, b, fused):
    """_nerf_update_all's draws for B images: per image from split(key, B),
    or the fused step's (per-image indices from split(key', B), one render
    key)."""
    if not fused:
        return [_image_draws(k, cfg) for k in jax.random.split(key, b)]
    key, k_render = jax.random.split(key)
    inds = torch.cat([_t(jax.random.randint(k, (N_RAYS,), 0, H * W))
                      for k in jax.random.split(key, b)])
    return _render_draws(k_render, cfg, inds)


def _augment_params(key, n):
    """_augment_rendered's draws: augment's for each of split(key, n)."""
    return stack([jax_params(k, (H, W), (H, W))
                  for k in jax.random.split(key, n)])


def _joint_draws(key, cfg, b_new, fix_nerf, fused):
    """JointTrainer.joint_step's draws for `key`, split as its
    separate-dispatch path splits them: the NeRF updates', then the
    augmentation's (the seg step's dropout key is unused: pinned off)."""
    draws = {}
    if b_new:
        if not fix_nerf:
            key, k = jax.random.split(key)
            draws["nerf"] = _nerf_draws(k, cfg, b_new, fused)
        key, k = jax.random.split(key)
        draws["augment"] = _augment_params(k, b_new)
    return draws


# ------------------------------------------------------------- checks
def _close(a, b, rel):
    a, b = float(a), float(b)
    assert np.isfinite(a) and abs(a - b) <= rel * abs(b), (a, b)


def _check_logs(logs_t, logs_j):
    assert set(logs_t) == set(logs_j)
    for k in logs_j:
        _close(logs_t[k], logs_j[k], 2e-3)


def _check_seg(tt, seg_state, rendered=False, stepped=True):
    """The running stats and (after a step) the seg step's gradient over all
    parameters: within 1e-4 relative of their largest magnitude and 1e-4
    of the gradient's norm when both sides' seg inputs are the same; when
    the batch holds renders, whose rgb differ by up to 1e-4 and whose
    labels may flip at near-ties (the seg net's CE gradient is a sum of
    per-pixel terms that mostly cancel at a fresh net, so one flipped
    pixel moves it by per cents), within 1e-3 and 0.25."""
    stats_tol, grad_tol = (1e-3, 0.25) if rendered else (1e-4, 1e-4)
    ref = deeplab_state_from_jax(seg_state[0], seg_state[1])
    state = tt.seg.model.state_dict()
    for k, r in ref.items():
        if "running" in k:
            assert rel_err(state[k].numpy(), r.numpy()) < stats_tol, k
    if stepped:
        grads = deeplab_state_from_jax(seg_state[2][0], seg_state[1])
        named = list(tt.seg.model.named_parameters())
        g = torch.cat([p.grad.double().reshape(-1) for _, p in named])
        r = torch.cat([grads[k].double().reshape(-1) for k, _ in named])
        assert float((g - r).norm() / r.norm()) <= grad_tol


def _level_sums(grad, spec):
    g = np.asarray(grad, np.float64)
    sums, mass = [], []
    for lvl in range(spec.n_levels):
        rows = g[spec.offsets[lvl]:spec.offsets[lvl] + spec.sizes[lvl]]
        sums.append(rows.sum(0))
        mass.append(np.abs(rows).sum())
    return np.stack(sums), np.array(mass)


def _check_nerf(tt, nerf_state, steps, stochastic=False):
    """The NeRF after `steps` Adam steps: its last step's gradient within
    2e-2 of each MLP tensor's norm (and of the exact table gradient's), per
    level and feature the sum of the table gradient within 5e-3 of the
    level's L1 mass (the semantics head's 50× wider bf16 products round
    further than tests/test_torch_train.py's 1e-3 allows) and, after one
    step from zero moments (lr·g/|g|: each element moves by ±lr), at most
    1 % of the elements moved the other way (their gradient sits at
    rounding level). After two steps the second gradient is taken at
    parameters whose rounding-level elements may already differ by 2·lr:
    1e-1 of the norm and the level sums within 1e-2 of the mass."""
    grads = params_from_jax(nerf_state[1][0])
    params = params_from_jax(nerf_state[0])
    norm_tol, sum_tol = (2e-2, 5e-3) if steps == 1 else (1e-1, 1e-2)
    spec = tt.nerf.model.encoder.spec
    for name, ref in grads.items():
        p = tt.nerf.model.get_parameter(name)
        if name == "encoder.table":
            sums_j, mass = _level_sums(ref, spec)
            sums_t, _ = _level_sums(p.grad, spec)
            assert (np.abs(sums_t - sums_j) <= sum_tol * mass[:, None]
                    ).all(), np.abs(sums_t - sums_j).max(-1) / mass
            if stochastic:
                continue
        g, r = p.grad.double(), ref.double()
        assert float((g - r).norm() / r.norm()) <= norm_tol, name
        if steps == 1:
            flipped = (p.detach() - params[name]).abs() > 1e-6
            assert float(flipped.double().mean()) <= 1e-2, name


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("which", ["proposal", "32+32", "default",
                                   "explicit_test", "explicit_predict"])
def test_derived_configs_and_budget_summary_match_jax(which):
    """test_cfg and predict_cfg field by field (every field the port's
    RenderConfig has) and budget_summary, its packed_dtype included."""
    train = {"proposal": dict(num_steps=24, upsample_steps=8,
                              proposal_placement=True),
             "32+32": dict(num_steps=32, upsample_steps=32)}.get(which, {})
    test = dict(num_steps=20, upsample_steps=10, early_stop=True,
                stage1_steps=6) if which == "explicit_test" else None
    predict = dict(num_steps=12, upsample_steps=6) \
        if which == "explicit_predict" else None
    mk = lambda mod, kw: None if kw is None else mod.RenderConfig(**kw)
    small = dict(nerf_model=SemanticNeRF(**MODEL_KW, device="cpu"),
                 seg_model=DeepLabV3(**SEG_KW, device="cpu"), device="cpu")
    jt = JJoint(EXP, num_classes=C, render_cfg=mk(jr, train),
                test_render_cfg=mk(jr, test),
                predict_render_cfg=mk(jr, predict),
                nerf_model=JNeRF(**MODEL_KW), seg_model=jdl.DeepLabV3(
                    **SEG_KW))
    tt = JointTrainer(EXP, num_classes=C, render_cfg=mk(tr, train),
                      test_render_cfg=mk(tr, test),
                      predict_render_cfg=mk(tr, predict), **small)
    fields = tr.RenderConfig.__dataclass_fields__
    for name in ("cfg", "test_cfg", "predict_cfg"):
        for f in fields:
            assert getattr(getattr(tt, name), f) == \
                getattr(getattr(jt, name), f), (name, f)
    assert tt.budget_summary() == jt.budget_summary()


def test_seg_pseudo_labels_match_jax(setup):
    """10 images, chunks of 4 (the last padded): eval-mode labels equal on
    every pixel, running stats untouched."""
    jt, tt, nerf, seg, _ = setup
    _, seg_state = _start(setup)
    images = np.random.default_rng(1).uniform(0, 1, (10, H, W, 3)).astype(
        np.float32)
    ref = jt.seg_pseudo_labels(seg_state, images, chunk=4)
    got = tt.seg_pseudo_labels(images, chunk=4)
    assert got.shape == (10, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _check_seg(tt, seg_state, stepped=False)


@pytest.fixture(scope="module")
def jax_stochastic(setup):
    """The JAX trainer over the same NeRF with the stochastic (single
    corner) table gradient."""
    jt = JJoint(EXP, image_hw=(H, W), num_classes=C,
                render_cfg=jr.RenderConfig(**CFG_KW), n_rays=N_RAYS,
                nerf_model=JNeRF(**MODEL_KW), seg_model=setup[0].seg_model)
    jt.nerf_tx = optax.chain(_stash_grads(), jt.nerf_tx)
    return jt


@pytest.mark.parametrize("mode", ["per_image", "fused", "stochastic"])
def test_nerf_fit_step_matches_jax(setup, jax_stochastic, mode):
    """nerf_fit_step at B = 2: two per-image steps, or one fused step (with
    the exact and with the stochastic table gradient): the image-mean
    losses and the last step's gradient."""
    fuse = mode != "per_image"
    nerf_state, seg_state = _start(setup, fuse=fuse,
                                   stochastic=mode == "stochastic")
    jt, tt, _, _, grid = setup
    if mode == "stochastic":
        jt = jax_stochastic
        jt.fused_image_step = True
    batch = _new_batch(np.random.default_rng(2), 2)
    key = jax.random.key(3)
    nerf_state, parts_j = jt.nerf_fit_step(nerf_state, seg_state, batch, key,
                                           occ_grid=grid)
    parts_t = tt.nerf_fit_step(batch, None, _t(grid),
                               draws=_nerf_draws(key, jt.cfg, 2, fuse))
    _check_logs(parts_t, parts_j)
    _check_nerf(tt, nerf_state, 1 if fuse else 2,
                stochastic=mode == "stochastic")


def test_nerf_fit_epoch_matches_jax(setup):
    """One epoch of 5 images in a shuffled order with a refresh every 3
    steps, the slab counter carried from a refresh before it: epoch-mean
    losses, the grid's refreshed slab as tests/test_torch_train.py holds a
    refresh (where the probe positions agree bit for bit), occ_step and
    the slab counter."""
    jt, tt, _, _, grid = setup
    nerf_state, seg_state = _start(setup)
    rng = np.random.default_rng(4)
    buffers = _new_batch(rng, 5)
    buffers["pseudo"] = jt.seg_pseudo_labels(seg_state, buffers["img"])
    order = rng.permutation(5)
    occ_step = 1
    jt._occ_slab = tt.nerf._occ_slab = 3
    key = jax.random.key(5)
    out_j = jt.nerf_fit_epoch(nerf_state, {k: jnp.asarray(v) for k, v in
                                           buffers.items()}, order, key,
                              occ_step, occ_grid=grid)
    steps, refresh, k = [], [], key
    cells = OCC_RES ** 3 // jt.occ_cfg.refresh_slabs
    for s in range(len(order)):
        k, k1 = jax.random.split(k)
        steps.append([_image_draws(jax.random.split(k1, 1)[0], jt.cfg)])
        if (occ_step + s + 1) % UPDATE_EVERY == 0:
            k, k2 = jax.random.split(k)
            refresh.append(_t(jax.random.uniform(k2, (cells, 3))))
    grid_t, step_t, parts_t = tt.nerf_fit_epoch(
        {k: _t(v) for k, v in buffers.items()}, order, None, occ_step,
        _t(grid), draws={"steps": steps, "refresh": refresh})
    assert len(refresh) == 2
    assert step_t == out_j[3] == occ_step + 5
    assert tt.nerf._occ_slab == jt._occ_slab == 1
    _check_logs(parts_t, out_j[4])
    # the refreshes probed slabs 3 and 0 (the counter started at 3): where
    # a probe position has the same f32 bits on both sides (XLA folds the
    # constants of the probe arithmetic; tests/test_torch_train.py) within
    # 5e-2 relative (sigma = exp of a bf16 logit, at parameters that Adam
    # moved by ±lr where a gradient sits at rounding level); slabs 1 and 2
    # only decayed, the same on both sides
    cells = OCC_RES ** 3 // 4
    got, ref = grid_t.numpy().reshape(-1), np.asarray(out_j[1]).reshape(-1)
    assert np.isfinite(got).all()
    for slab, jitter in ((3, refresh[0]), (0, refresh[1])):
        same = _probe_bits_agree(slab, jitter)
        assert same.mean() > 0.3
        sl = slice(slab * cells, (slab + 1) * cells)
        np.testing.assert_allclose(got[sl][same], ref[sl][same], rtol=5e-2)
    np.testing.assert_array_equal(got[cells:3 * cells], ref[cells:3 * cells])


def _check_render(out_t, out_j):
    """As tests/test_torch_render.py holds a render."""
    for k, (mx, mean) in (("nerf_rgb", (3e-3, 1e-4)),
                          ("nerf_semantics_raw", (3e-3, 1e-4)),
                          ("nerf_depth", (3e-2, 1e-3))):
        d = np.abs(out_t[k].numpy() - np.asarray(out_j[k]))
        assert d.max() <= mx and d.mean() <= mean, (k, d.max(), d.mean())
    _check_labels(out_t["nerf_semantics"].numpy(),
                  np.asarray(out_j["nerf_semantics"]),
                  out_t["nerf_semantics_raw"].numpy(),
                  np.asarray(out_j["nerf_semantics_raw"]))


def _check_labels(got, ref, probs_got, probs_ref):
    """Argmax labels equal wherever JAX's two most probable classes are
    further apart than twice the largest difference of the probabilities
    (nearer, the two sides' argmaxes may differ), on at least 99 % of the
    pixels."""
    top2 = np.sort(probs_ref, axis=-1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= 2 * np.abs(probs_got - probs_ref
                                                    ).max()
    np.testing.assert_array_equal(got[~tie], ref[~tie])
    assert (got == ref).mean() >= 0.99


@pytest.mark.parametrize("which", ["test", "predict"])
def test_render_frames_match_jax(setup, which):
    """3 frames in groups of 2 (frames share 512-ray chunks) at the derived
    test and predict budgets."""
    jt, tt, nerf, _, grid = setup
    _start(setup)
    poses = np.stack([_pose(k) for k in range(3)])
    out_j = jt.render_frames(nerf, poses, INTRINSICS, grid, group=2,
                             which=which)
    out_t = tt.render_frames(poses, INTRINSICS, _t(grid), group=2,
                             which=which)
    assert out_t["nerf_semantics_raw"].shape == (3, H, W, C)
    _check_render(out_t, out_j)
    with pytest.raises(ValueError, match="which"):
        tt._render_frame(poses[0], INTRINSICS, _t(grid), which="train")


@pytest.mark.parametrize("with_image", [False, True])
def test_predict_frame_matches_jax(setup, with_image):
    """The predict-budget render and the seg net's labels of the given
    image, or of the render (a novel viewpoint)."""
    jt, tt, nerf, _, grid = setup
    nerf_state, seg_state = _start(setup)
    image = np.random.default_rng(6).uniform(0, 1, (H, W, 3)).astype(
        np.float32) if with_image else None
    out_j = jt.predict_frame(nerf_state, seg_state, _pose(1), INTRINSICS,
                             image=image, occ_grid=grid)
    out_t = tt.predict_frame(_pose(1), INTRINSICS, image=image,
                             occ_grid=_t(grid))
    _check_render({k: v[None] for k, v in out_t.items()},
                  {k: np.asarray(v)[None] for k, v in out_j.items()})
    np.testing.assert_array_equal(out_t["seg_semantics"].numpy(),
                                  np.asarray(out_j["seg_semantics"]))


# name: (new images, old images, cl replay (b, k) or None)
COMPOSITIONS = {"new": (2, 0, None), "new_old": (2, 1, None),
                "new_old_cl": (2, 1, (1, 1)), "old_cl": (0, 1, (1, 2)),
                "fix_nerf": (2, 0, None)}


@pytest.mark.parametrize("comp", list(COMPOSITIONS))
def test_joint_step_matches_jax(setup, comp):
    """One joint_step in each composition from the shared start with JAX's
    draws: the logs (the seg loss and, when the NeRF trains, its image-mean
    losses), the seg net's running stats (the BN trick at B = 2, then the
    seg step) and parameters, and the last NeRF step's gradient; under
    fix_nerf the NeRF does not move."""
    jt, tt, nerf, _, grid = setup
    b_new, b_old, cl = COMPOSITIONS[comp]
    fix = comp == "fix_nerf"
    nerf_state, seg_state = _start(setup, fix_nerf=fix)
    rng = np.random.default_rng(list(COMPOSITIONS).index(comp) + 10)
    new = _new_batch(rng, b_new) if b_new else None
    old = {"img": rng.uniform(0, 1, (b_old, H, W, 3)).astype(np.float32),
           "nerf_label": _labels(rng, (b_old, H, W))} if b_old else None
    replay = {"replay_img": rng.uniform(0, 1, (*cl, H, W, 3)).astype(
        np.float32), "replay_label": _labels(rng, (*cl, H, W))} \
        if cl else None
    key = jax.random.key(20)
    draws = _joint_draws(key, jt.cfg, b_new, fix, False)
    nerf_j, seg_j, logs_j = jt.joint_step(nerf_state, seg_state, old, new,
                                          replay, key, occ_grid=grid)
    seen = []
    update = tt.seg.update
    tt.seg.update = lambda *a, **kw: seen.append(a[:2]) or update(*a, **kw)
    try:
        logs_t = tt.joint_step(old, new, replay, torch.Generator(), _t(grid),
                               draws=draws)
    finally:
        del tt.seg.update
    _check_logs(logs_t, logs_j)
    assert ("loss_nerf_total" in logs_t) == (b_new > 0 and not fix)
    # the assembled seg batch, rendered ⊕ old ⊕ cl, against JAX's pieces:
    # the render, its augmentation (JAX's key for it) and the replay
    imgs, labels = seen[0]
    imgs_j, labels_j = [], []
    if b_new:
        rendered = jt.render_frames(nerf, new["pose"], new["intrinsics"][0],
                                    grid)
        k_aug = jax.random.split(key)[1]
        if not fix:
            k_aug = jax.random.split(jax.random.split(key)[0])[1]
        aug = jt._augment_rendered(k_aug, rendered["nerf_rgb"],
                                   rendered["nerf_semantics"])
        imgs_j.append(np.asarray(aug[0]))
        labels_j.append(np.asarray(aug[1]))
    if old is not None:
        imgs_j.append(old["img"])
        labels_j.append(old["nerf_label"])
    if replay is not None:
        imgs_j.append(replay["replay_img"].reshape(-1, H, W, 3))
        labels_j.append(replay["replay_label"].reshape(-1, H, W))
    imgs_j, labels_j = np.concatenate(imgs_j), np.concatenate(labels_j)
    assert imgs.shape == imgs_j.shape and labels.dtype == torch.int64
    d = np.abs(imgs.numpy() - imgs_j)
    assert d.max() <= 3e-3 and d.mean() <= 1e-4
    assert (labels.numpy() == labels_j).mean() >= 0.99
    _check_seg(tt, seg_j, rendered=b_new > 0)
    if "loss_nerf_total" in logs_t:
        _check_nerf(tt, nerf_j, steps=b_new)
    else:
        for name, p in params_from_jax(nerf).items():
            assert torch.equal(tt.nerf.model.get_parameter(name).detach(), p)
