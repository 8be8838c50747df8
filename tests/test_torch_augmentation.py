"""The port's on-device augmentation against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed; the JAX functions run per image
(jitted, as its joint trainer runs them under vmap), the port's batched.
JAX's random parameters are replayed from its own key splits (augment's
split(key, 5), then color_jitter's split(k_jit, 5), permutation, uniform,
randint), as tests/test_torch_train.py replays the rays' draws.

Tolerances:
  * rgb ↔ hsv, each jitter op at given factors, the permuted color_jitter,
    the bilinear rotation and augment's image: 1e-5 absolute (f32 ops in
    the same order; only the luma's three-term sum and sin / cos may round
    the last bit differently);
  * the nearest-neighbour labels: equal except where a rotated coordinate
    sits within 1e-4 of a rounding tie (both sides round half to even),
    on at most 0.1 % of the pixels;
  * crop, flip and only_crop: exact.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu.data import augmentation as ja
from ucsa_neural_rendering_tpu_torch.data import augmentation as ta

BCSH = (0.3, 0.3, 0.3, 0.05)


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, n, hw):
    """U(0, 1) images with a few gray, black, white and saturated pixels
    (delta 0, max 0, each channel the max), and +1-shifted label maps."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, *hw, 3)).astype(np.float32)
    img[:, 0, :4] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 1, 1], [1, 0, 0]]
    img[:, 1, :3] = [[0, 1, 0], [0, 0, 1], [0.2, 0.9, 0.9]]
    labels = rng.integers(0, 7, (n, *hw)).astype(np.float32)
    return img, labels


def jax_params(key, hw, out_hw, degrees=10.0, flip_p=0.5, bcsh=BCSH):
    """augment's draws for one key, as draw_augment_params returns them."""
    k_jit, k_rot, k_ci, k_cj, k_flip = jax.random.split(key, 5)
    k_perm, *k_f = jax.random.split(k_jit, 5)
    lo = [1 - bcsh[0], 1 - bcsh[1], 1 - bcsh[2], -bcsh[3]]
    hi = [1 + bcsh[0], 1 + bcsh[1], 1 + bcsh[2], bcsh[3]]
    return {
        "order": np.asarray(jax.random.permutation(k_perm, 4)),
        "factors": np.array([jax.random.uniform(k, (), minval=a, maxval=b)
                             for k, a, b in zip(k_f, lo, hi)], np.float32),
        "angle": np.asarray(jax.random.uniform(k_rot, (), minval=-degrees,
                                               maxval=degrees)),
        "i": np.asarray(jax.random.randint(k_ci, (), 0,
                                           hw[0] - out_hw[0] + 1)),
        "j": np.asarray(jax.random.randint(k_cj, (), 0,
                                           hw[1] - out_hw[1] + 1)),
        "flip": np.asarray(jax.random.uniform(k_flip, ()) < flip_p)}


def stack(params):
    return {k: _t(np.stack([p[k] for p in params])) for k in params[0]}


def test_rgb_hsv_round_trip_matches_jax():
    img, _ = _images(0, 2, (9, 12))
    hsv_j = np.asarray(jax.jit(ja._rgb_to_hsv)(img))
    hsv_t = ta._rgb_to_hsv(_t(img))
    np.testing.assert_allclose(hsv_t.numpy(), hsv_j, atol=1e-5, rtol=0)
    rgb_j = np.asarray(jax.jit(ja._hsv_to_rgb)(hsv_j))
    np.testing.assert_allclose(ta._hsv_to_rgb(_t(hsv_j)).numpy(), rgb_j,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(rgb_j, img, atol=1e-5)


OPS = {"brightness": (ja._adjust_brightness, ta.adjust_brightness, 0.3),
       "contrast": (ja._adjust_contrast, ta.adjust_contrast, 0.3),
       "saturation": (ja._adjust_saturation, ta.adjust_saturation, 0.3),
       "hue": (ja._adjust_hue, ta.adjust_hue, 0.05)}


@pytest.mark.parametrize("name", list(OPS))
def test_jitter_op_matches_jax(name):
    """Each op on 3 images at the factor JAX draws from each image's key
    (the hue op: its shift)."""
    fj, ft, strength = OPS[name]
    img, _ = _images(1, 3, (9, 12))
    keys = jax.random.split(jax.random.key(2), 3)
    lo, hi = (-strength, strength) if name == "hue" else \
        (1 - strength, 1 + strength)
    factors = np.array([jax.random.uniform(k, (), minval=lo, maxval=hi)
                        for k in keys], np.float32)
    ref = np.stack([np.asarray(jax.jit(partial(fj, strength=strength))(
        k, im)) for k, im in zip(keys, img)])
    out = ft(_t(img), _t(factors)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_color_jitter_matches_jax():
    """The four ops in each image's permuted order at its factors, 4
    images."""
    img, _ = _images(3, 4, (9, 12))
    keys = jax.random.split(jax.random.key(4), 4)
    jitter = jax.jit(ja.color_jitter)
    ref = np.stack([np.asarray(jitter(k, im)) for k, im in zip(keys, img)])
    orders, factors = [], []
    for k in keys:
        k_perm, *k_f = jax.random.split(k, 5)
        orders.append(np.asarray(jax.random.permutation(k_perm, 4)))
        factors.append([jax.random.uniform(kf, (), minval=a, maxval=b)
                        for kf, a, b in zip(k_f, [0.7, 0.7, 0.7, -0.05],
                                            [1.3, 1.3, 1.3, 0.05])])
    assert len({tuple(o) for o in orders}) > 1  # the orders differ
    out = ta.color_jitter(_t(img), _t(np.stack(orders)),
                          _t(np.array(factors, np.float32))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def _near_tie(angle, hw, tol=1e-4):
    """Pixels whose rotated coordinate (f64) sits within tol of a .5
    rounding tie, as _rotate maps them."""
    h, w = hw
    theta = -np.float64(angle) * np.pi / 180.0
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = np.cos(theta) * (yy - cy) - np.sin(theta) * (xx - cx) + cy
    xs = np.sin(theta) * (yy - cy) + np.cos(theta) * (xx - cx) + cx
    tie = lambda v: np.abs(np.abs(v - np.floor(v)) - 0.5) < tol
    return tie(ys) | tie(xs)


@pytest.mark.parametrize("hw", [(48, 64), (47, 63)])
@pytest.mark.parametrize("angle", [0.0, 3.7, -3.7, 10.0, -10.0])
def test_rotate_matches_jax(angle, hw):
    """Bilinear image within 1e-5; nearest labels equal off the near-ties
    and on all but 0.1 % of the pixels (out-of-bounds taps filled with 0
    on both sides). The batched port rotates two images at ±angle at
    once."""
    img, labels = _images(5, 2, hw)
    angles = np.array([angle, -angle], np.float32)
    rot = jax.jit(ja._rotate, static_argnames="order")
    for order, x in ((1, img), (0, labels)):
        ref = np.stack([np.asarray(rot(x[k], angles[k], order=order))
                        for k in range(2)])
        out = ta._rotate(_t(x), _t(angles), order).numpy()
        assert out.shape == x.shape
        if order == 1:
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
            continue
        for k in range(2):
            differ = out[k] != ref[k]
            assert not (differ & ~_near_tie(angles[k], hw)).any()
            assert differ.mean() <= 1e-3


def test_crop_flip_and_only_crop_match_jax():
    """Per-image crop offsets against JAX's _crop, the flip inside augment
    (covered by test_augment_matches_jax), and only_crop's centre crop:
    exact."""
    img, labels = _images(6, 3, (30, 41))
    ii, jj = np.array([0, 3, 6]), np.array([9, 0, 4])
    crop = jax.jit(ja._crop, static_argnames="out_hw")
    ref = np.stack([np.asarray(crop(img[k], ii[k], jj[k], out_hw=(24, 32)))
                    for k in range(3)])
    out = ta._crop(_t(img), _t(ii), _t(jj), (24, 32)).numpy()
    np.testing.assert_array_equal(out, ref)
    ref_l = np.stack([np.asarray(crop(labels[k], ii[k], jj[k],
                                      out_hw=(24, 32))) for k in range(3)])
    np.testing.assert_array_equal(
        ta._crop(_t(labels), _t(ii), _t(jj), (24, 32)).numpy(), ref_l)
    ri, rl = [], []
    for k in range(3):
        a, (b,) = ja.augment_jit(jax.random.key(k), img[k], [labels[k]],
                                 out_hw=(24, 32), only_crop=True)
        ri.append(np.asarray(a))
        rl.append(np.asarray(b))
    oi, (ol,) = ta.augment(_t(img), [_t(labels)], None, out_hw=(24, 32),
                           only_crop=True)
    np.testing.assert_array_equal(oi.numpy(), np.stack(ri))
    np.testing.assert_array_equal(ol.numpy(), np.stack(rl))
    with pytest.raises(ValueError, match="smaller than the output"):
        ta.augment(_t(img), [], None, out_hw=(31, 41), only_crop=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_matches_jax(seed):
    """augment as a whole, 6 images of 30×40 to 24×32 with two label maps,
    each image's parameters replayed from its JAX key: the image within
    1e-5, the labels equal off rotation near-ties (at most 0.1 %)."""
    hw, out_hw = (30, 40), (24, 32)
    img, lab = _images(10 + seed, 6, hw)
    lab2 = lab[:, ::-1, ::-1].copy()
    keys = jax.random.split(jax.random.key(seed), 6)
    ref_i, ref_l = [], []
    for k, key in enumerate(keys):
        a, ls = ja.augment_jit(key, img[k], [lab[k], lab2[k]], out_hw=out_hw)
        ref_i.append(np.asarray(a))
        ref_l.append(np.stack([np.asarray(x) for x in ls]))
    params = stack([jax_params(k, hw, out_hw) for k in keys])
    assert 0 < int(params["flip"].sum()) < 6  # flipped and not
    out_i, out_l = ta.augment(_t(img), [_t(lab), _t(lab2)], params,
                              out_hw=out_hw)
    assert out_i.shape == (6, *out_hw, 3)
    np.testing.assert_allclose(out_i.numpy(), np.stack(ref_i), atol=1e-5,
                               rtol=0)
    got = np.stack([o.numpy() for o in out_l], 1)
    differ = got != np.stack(ref_l)
    assert differ.mean() <= 1e-3


def test_draw_augment_params():
    """Shapes, ranges and reproducibility from the generator's seed; every
    order is a permutation of the four ops."""
    draw = lambda: ta.draw_augment_params(
        torch.Generator().manual_seed(7), 256, (30, 40), (24, 32),
        device="cpu")
    p = draw()
    assert torch.equal(p["angle"], draw()["angle"])
    assert (p["order"].sort(dim=-1).values == torch.arange(4)).all()
    lo = torch.tensor([0.7, 0.7, 0.7, -0.05])
    hi = torch.tensor([1.3, 1.3, 1.3, 0.05])
    assert ((p["factors"] >= lo) & (p["factors"] <= hi)).all()
    assert p["angle"].abs().max() <= 10.0
    assert p["i"].min() >= 0 and p["i"].max() <= 6
    assert p["j"].min() >= 0 and p["j"].max() <= 8
    assert 0.3 < p["flip"].float().mean() < 0.7
