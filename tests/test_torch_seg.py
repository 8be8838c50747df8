"""The port's DeepLabV3-ResNet101, its weight converter and checkpoint
loader, and its meter, against the JAX package on the CPU.

Both sides start from one set of weights: a JAX parameter tree drawn with
numpy from a seed at the shapes `jax.eval_shape` gives the JAX model, carried
to the port by `deeplab_state_from_jax`. TINY_LAYOUT at narrow widths keeps
the graph (stem, strides, dilations, downsamples, ASPP, head) at a fraction
of the operations.

Dropout is pinned off for the value checks, as tests/test_joint_twin.py
pins what torch and JAX cannot share (their RNG streams): in train mode the
JAX side applies with deterministic=True and the port's dropout runs at
rate 0 (flax's Dropout at rate 0 is the identity too). The dropout test
holds the port's mask to its generator instead.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_deeplab import fake_torchvision_state_dict
from torch_deeplab_twin import DeepLabV3TV
from ucsa_neural_rendering_tpu.metrics import meter as jmeter
from ucsa_neural_rendering_tpu.models import deeplabv3 as jdl
from ucsa_neural_rendering_tpu.models import resnet as jrn
from ucsa_neural_rendering_tpu_torch.metrics import meter as pmeter
from ucsa_neural_rendering_tpu_torch.models import (TINY_LAYOUT, DeepLabV3,
                                                    deeplab_state_from_jax,
                                                    load_deeplab_checkpoint,
                                                    resize_bilinear)
from ucsa_neural_rendering_tpu_torch.models.resnet import BatchNorm2d

SMALL = dict(num_classes=5, backbone_layout=TINY_LAYOUT, aspp_channels=8,
             head_channels=8)
# (use_running_average, deterministic) of each JAX mode
MODES = {"train": (False, False), "eval": (True, True),
         "bn_trick": (False, True)}


def jax_weights(model, image_shape, seed=0):
    """A JAX (params, batch_stats) pair of numpy leaves at the model's
    shapes (jax.eval_shape: no init run), drawn from `seed`: conv kernels
    N(0, 1/fan_in), BN scale U(0.5, 1.5), bias N(0, 0.1²), running mean
    N(0, 0.1²), var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(partial(model.init, use_running_average=False,
                                    deterministic=True),
                            jax.random.key(0), jnp.zeros(image_shape))

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            a = rng.normal(size=shape) * 0.1
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree["params"], tree["batch_stats"]


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def rel_err(a, b):
    """max |a − b| over max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def stats_err(port_model, jax_stats, jax_params):
    """The largest relative error, over the BN buffers, of the port's
    running stats against a JAX batch_stats tree."""
    ref = deeplab_state_from_jax(jax_params, jax_stats)
    state = port_model.state_dict()
    return max(rel_err(state[k].numpy(), ref[k].numpy()) for k in ref
               if "running" in k)


def pin_dropout_off(model):
    model.classifier[0].dropout.p = 0.0


@pytest.fixture(scope="module")
def small():
    jm = jdl.DeepLabV3(**SMALL)
    params, stats = jax_weights(jm, (1, 48, 64, 3))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    return jm, params, stats, x


def port_model(params, stats):
    model = DeepLabV3(**SMALL, device="cpu")
    model.load_state_dict(deeplab_state_from_jax(params, stats))
    return model


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_deeplab_matches_jax(small, mode, batch):
    """Logits within 1e-4 of their largest magnitude and the updated
    running stats within 1e-4 relative, in each JAX mode (dropout pinned
    off in train mode); batch 1 puts the ASPP pooling BN at one value per
    channel."""
    jm, params, stats, x = small
    x = x[:batch]
    ura, det = MODES[mode]
    with jax.default_matmul_precision("float32"):
        out, mutated = jm.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), use_running_average=ura,
                                deterministic=True, mutable=["batch_stats"])
    model = port_model(params, stats).set_mode(ura, det)
    pin_dropout_off(model)
    with torch.no_grad():
        logits = model(to_nchw(x), torch.Generator())["out"]
    assert logits.shape == (batch, 5, 48, 64) and logits.dtype == torch.float32
    assert rel_err(to_nhwc(logits), out["out"]) < 1e-4
    assert stats_err(model, mutated["batch_stats"], params) < 1e-4
    if ura:
        assert stats_err(model, stats, params) == 0.0


@pytest.mark.parametrize("use_running_average", [False, True])
def test_backbone_and_aspp_match_jax(small, use_running_average):
    """The backbone's features and the ASPP's output (dropout off), each
    fed the same input, within 1e-4 of their largest magnitude; their
    updated running stats within 1e-4 relative."""
    jm, params, stats, x = small
    model = port_model(params, stats).set_mode(use_running_average, True)
    ura = use_running_average
    with jax.default_matmul_precision("float32"):
        feats, m_bb = jrn.ResNet101Backbone(layout=TINY_LAYOUT).apply(
            {"params": params["backbone"],
             "batch_stats": stats["backbone"]},
            jnp.asarray(x), ura, mutable=["batch_stats"])
        aspp, m_aspp = jdl.ASPP(out_channels=8).apply(
            {"params": params["aspp"], "batch_stats": stats["aspp"]},
            feats, ura, True, mutable=["batch_stats"])
    with torch.no_grad():
        p_feats = model.backbone(to_nchw(x))
        p_aspp = model.classifier[0](to_nchw(np.asarray(feats)))
    assert p_feats.shape == (2, 32, 6, 8)
    assert rel_err(to_nhwc(p_feats), feats) < 1e-4
    assert rel_err(to_nhwc(p_aspp), aspp) < 1e-4
    new_stats = dict(stats, backbone=m_bb["batch_stats"],
                     aspp=m_aspp["batch_stats"])
    assert stats_err(model, new_stats, params) < 1e-4


def test_dropout_draws_from_its_generator(small):
    """Train mode drops half the projected ASPP features and doubles the
    rest, with the mask drawn from the generator passed to forward: the
    same seed gives the same logits, another seed others, and eval mode or
    the BN trick none; without a generator train mode raises."""
    _, params, stats, x = small
    model = port_model(params, stats)
    aspp = model.classifier[0]
    feats = model.backbone(to_nchw(x)).detach()
    h = aspp.project(torch.cat(
        [b(feats) for b in aspp.convs[:-1]]
        + [aspp.convs[-1](feats).expand(-1, -1, 6, 8)], 1)).detach()
    mask = torch.rand(h.shape, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = aspp(feats, torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(out, torch.where(mask < 0.5, h / 0.5,
                                                       0.0))
        dropped = (out[h > 0] == 0).float().mean()  # after the ReLU
        assert 0.4 < float(dropped) < 0.6
        runs = [model(to_nchw(x), torch.Generator().manual_seed(s))["out"]
                for s in (7, 7, 8)]
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])
        with pytest.raises(ValueError, match="Generator"):
            model(to_nchw(x))
        model.set_mode(use_running_average=False, deterministic=True)
        a = model(to_nchw(x), torch.Generator().manual_seed(7))["out"]
        model.eval()
        b = model(to_nchw(x), torch.Generator().manual_seed(7))["out"]
        c = model(to_nchw(x))["out"]
    pin_dropout_off(model.train())
    with torch.no_grad():
        d = model(to_nchw(x), torch.Generator().manual_seed(7))["out"]
    assert torch.equal(b, c)
    assert not torch.equal(a, runs[0])
    # the BN trick is train mode with dropout off
    assert torch.allclose(a, d, rtol=0, atol=1e-6)


def test_batchnorm_one_value_per_channel_as_jax():
    """Train mode at n = 1 value per channel (torch's own BatchNorm2d
    raises): the output is the bias, the running mean moves to the value,
    the running var takes 0.9·var (Bessel 1 on a variance of 0), and the
    gradients are JAX's; within 1e-6."""
    from ucsa_neural_rendering_tpu.models.resnet import TorchBatchNorm
    rng = np.random.default_rng(2)
    c = 6
    x = rng.normal(size=(1, 1, 1, c)).astype(np.float32)
    w, b, m, v = (rng.uniform(0.5, 1.5, c).astype(np.float32)
                  for _ in range(4))
    variables = {"params": {"scale": w, "bias": b},
                 "batch_stats": {"mean": m, "var": v}}

    def f(xx, p):
        y, mut = TorchBatchNorm(use_running_average=False).apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, xx,
            mutable=["batch_stats"])
        return jnp.sum(y * jnp.arange(1, c + 1)), (y, mut)

    (_, (y, mut)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(m))
        bn.running_var.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x.reshape(1, c, 1, 1)).requires_grad_()
    yt = bn.train()(xt)
    (yt[0, :, 0, 0] * torch.arange(1, c + 1)).sum().backward()
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(yt.detach().reshape(-1), np.asarray(y)
                               .reshape(-1), **tol)
    np.testing.assert_allclose(yt.detach().reshape(-1), b, **tol)
    np.testing.assert_allclose(bn.running_mean, mut["batch_stats"]["mean"],
                               **tol)
    np.testing.assert_allclose(bn.running_var, mut["batch_stats"]["var"],
                               **tol)
    np.testing.assert_allclose(bn.running_var, 0.9 * v, **tol)
    np.testing.assert_allclose(xt.grad.reshape(-1), np.asarray(gx)
                               .reshape(-1), **tol)
    np.testing.assert_allclose(bn.weight.grad, gp["scale"], **tol)
    np.testing.assert_allclose(bn.bias.grad, gp["bias"], **tol)


@pytest.mark.parametrize("hw, out_hw", [((6, 8), (48, 64)),
                                        ((30, 40), (240, 320)),
                                        ((5, 6), (33, 41))])
def test_resize_bilinear_edges_match_jax(hw, out_hw):
    """The port's resize (jax.image.resize's per-axis weight matrices, as
    products) against jax.image.resize at the model's 8× upsample (and
    33×41 from 5×6, not a whole factor): every pixel, the edge rows and
    columns among them, within 1e-5 of the largest magnitude."""
    x = np.random.default_rng(4).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jdl.resize_bilinear(jnp.asarray(x), out_hw))
    out = to_nhwc(resize_bilinear(to_nchw(x), out_hw))
    assert out.shape == ref.shape
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
                 np.s_[:, :, -1]):
        assert rel_err(out[edge], ref[edge]) < 1e-5
    assert rel_err(out, ref) < 1e-5


def test_converter_covers_the_full_width_tree():
    """deeplab_state_from_jax over the full-width R101 tree (shapes from
    jax.eval_shape, no init run) gives exactly the port's state dict keys
    and shapes, which are torchvision's deeplabv3_resnet101's without the
    aux head."""
    shapes = jax.eval_shape(
        partial(jdl.DeepLabV3(num_classes=40).init,
                use_running_average=False, deterministic=True),
        jax.random.key(0), jnp.zeros((1, 33, 41, 3)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    state = deeplab_state_from_jax(zeros["params"], zeros["batch_stats"])
    ref = {k: tuple(v.shape) for k, v in
           DeepLabV3(num_classes=40, device="cpu").state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == ref
    tv = fake_torchvision_state_dict(np.random.default_rng(0),
                                     with_aux=False)
    assert {k: tuple(np.shape(v)) for k, v in tv.items()} == ref
    assert len(ref) == 668


@pytest.fixture(scope="module")
def torchvision_checkpoint():
    sd = {k: torch.as_tensor(v) for k, v in fake_torchvision_state_dict(
        np.random.default_rng(0), with_aux=True).items()}
    twin = DeepLabV3TV(num_classes=40)
    twin.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1, 3, 33, 41)).astype(np.float32))
    with torch.no_grad():
        ref = twin.eval()(x)["out"]
    return sd, x, ref


@pytest.mark.parametrize("fmt", ["lightning_ckpt", "pth"])
def test_load_deeplab_checkpoint_matches_torchvision_twin(
        torchvision_checkpoint, tmp_path, fmt):
    """A Lightning .ckpt ("state_dict" under the `_model._model.` prefix)
    or a bare .pth of torchvision's deeplabv3_resnet101 keys, aux head
    included, loads strict into a full-width port model whose eval logits
    are the torchvision twin's within 1e-4 of their largest magnitude."""
    sd, x, ref = torchvision_checkpoint
    path = tmp_path / "seg.ckpt"
    if fmt == "lightning_ckpt":
        torch.save({"epoch": 3, "state_dict": {
            "_model._model." + k: v for k, v in sd.items()}}, path)
    else:
        torch.save(sd, path)
    model = load_deeplab_checkpoint(path, device="cpu")
    assert model.num_classes == 40
    assert set(model.state_dict()) == {k for k in sd
                                       if "aux_classifier" not in k}
    with torch.no_grad():
        out = model.eval()(x)["out"]
    assert out.shape == (1, 40, 33, 41)
    assert rel_err(out.numpy(), ref.numpy()) < 1e-4


def test_init_is_flax_lecun_normal():
    """Every conv kernel of the full-width model is flax's lecun_normal:
    std within 5 % of sqrt(1 / fan_in) and no draw beyond the ±2 std of the
    untruncated normal it is cut from; the classifier bias 0; BN weight 1,
    bias 0, running mean 0, var 1; the global RNG untouched."""
    before = torch.random.get_rng_state()
    model = DeepLabV3(num_classes=40, device="cpu",
                      generator=torch.Generator().manual_seed(11))
    assert torch.equal(before, torch.random.get_rng_state())
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 104 + 8
    for conv in convs:
        w = conv.weight.detach()
        std = float(np.sqrt(1.0 / w[0].numel()))
        assert abs(float(w.std()) / std - 1) < 0.05, conv
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * (
            1 + 1e-6)
    assert not model.classifier[4].bias.any()
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm2d)):
        assert bool((bn.weight == 1).all() and not bn.bias.any())
        assert bool(not bn.running_mean.any() and (bn.running_var == 1)
                    .all())


def test_confusion_matrix_matches_jax():
    """Truths of -1 and out of range are dropped, preds clamped into range:
    the same int32 matrix as the JAX package's."""
    rng = np.random.default_rng(6)
    c = 7
    preds = rng.integers(-2, c + 2, (3, 20, 24))
    truths = rng.integers(-1, c + 2, (3, 20, 24))
    ref = np.asarray(jmeter.confusion_matrix_update(
        jnp.asarray(preds), jnp.asarray(truths), c))
    out = pmeter.confusion_matrix_update(torch.from_numpy(preds),
                                         torch.from_numpy(truths), c)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_semantics_meter_folds_as_jax():
    """40 updates (a fold after 32, then one at measure) and a precomputed
    matrix: the same int64 total and the same (mIoU, accuracy, class
    accuracy) as the JAX package's meter, exactly; clear empties it."""
    rng = np.random.default_rng(7)
    c = 5
    jm, pm = jmeter.SemanticsMeter(c), pmeter.SemanticsMeter(c)
    for i in range(40):
        preds = rng.integers(0, c, (2, 6, 8))
        truths = rng.integers(-1, c - 1, (2, 6, 8))  # class c-1 absent
        jm.update(preds, truths)
        pm.update(torch.from_numpy(preds), torch.from_numpy(truths))
        if i == 31:
            assert pm._dev is None and pm._host is not None
    extra = rng.integers(0, 50, (c, c)).astype(np.int32)
    jm.update_confmat(extra)
    pm.update_confmat(torch.from_numpy(extra))
    assert pm._pending == 9
    np.testing.assert_array_equal(pm.conf_mat, jm.conf_mat)
    assert pm.conf_mat.dtype == np.int64
    assert pm.measure() == jm.measure()
    pm.clear()
    assert pm.conf_mat is None
    with pytest.raises(ValueError, match="empty"):
        pm.measure()
