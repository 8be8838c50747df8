"""The port's SegTrainer, its loss, POLY factor and optimizers against the
JAX package's seg trainer on the CPU.

Both sides start from one set of weights (test_torch_seg.jax_weights,
carried to the port by deeplab_state_from_jax) at TINY_LAYOUT and narrow
widths. Dropout is pinned off on both sides, as test_torch_seg.py says:
the JAX step is composed from the package's own `cross_entropy_ignore`,
`model.apply(..., use_running_average=False, deterministic=True)` and
`make_seg_optimizer` (its jitted `SegTrainer.train_step` always drops
out, from a key torch cannot share), and the port's dropout runs at rate 0.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_seg import (SMALL, jax_weights, pin_dropout_off, rel_err,
                            to_nhwc)
from ucsa_neural_rendering_tpu.metrics.meter import confusion_matrix_update
from ucsa_neural_rendering_tpu.models import deeplabv3 as jdl
from ucsa_neural_rendering_tpu.train import seg_trainer as jst
from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3,
                                                    deeplab_state_from_jax)
from ucsa_neural_rendering_tpu_torch.train import seg_trainer as pst

H, W = 48, 64


@pytest.fixture(scope="module")
def setup():
    jm = jdl.DeepLabV3(**SMALL)
    params, stats = jax_weights(jm, (1, H, W, 3), seed=3)
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, 5, (2, H, W)).astype(np.int32)
    labels[rng.uniform(size=labels.shape) < 0.3] = -1

    @partial(jax.jit, static_argnames=("double_softmax",))
    def loss_and_grad(params, stats, images, labels, denom, double_softmax):
        def loss_fn(p):
            out, mutated = jm.apply(
                {"params": p, "batch_stats": stats}, images,
                use_running_average=False, deterministic=True,
                mutable=["batch_stats"])
            loss = jst.cross_entropy_ignore(out["out"], labels,
                                            double_softmax, denom=denom)
            return loss, (mutated["batch_stats"], out["out"])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return jm, params, stats, images, labels, loss_and_grad


def port_trainer(params, stats, cfg, double_softmax=False):
    trainer = pst.SegTrainer(DeepLabV3(**SMALL, device="cpu"), cfg,
                             double_softmax=double_softmax, device="cpu")
    trainer.init(deeplab_state_from_jax(params, stats))
    pin_dropout_off(trainer.model)
    return trainer


@pytest.mark.parametrize("double_softmax", [False, True])
@pytest.mark.parametrize("case", ["all_pixels", "denom", "all_ignored"])
def test_cross_entropy_ignore_matches_jax(double_softmax, case):
    """The CE summed over valid pixels over ALL pixels (or `denom`), -1
    ignored, with and without the double softmax, within 1e-6 relative;
    all labels ignored gives 0."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 7, 5, 6)).astype(np.float32) * 3
    labels = rng.integers(-1, 7, (3, 5, 6)).astype(np.int32)
    if case == "all_ignored":
        labels[:] = -1
    denom = 2 * 5 * 6 if case == "denom" else None
    ref = float(jst.cross_entropy_ignore(
        jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(labels),
        double_softmax, denom))
    out = float(pst.cross_entropy_ignore(torch.from_numpy(logits),
                                         torch.from_numpy(labels),
                                         double_softmax, denom))
    if case == "all_ignored":
        assert out == ref == 0.0
    else:
        assert out == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("epoch", [0, 1, 7, 19, 20, 25])
def test_poly_lr_factor_matches_jax(epoch):
    args = (epoch, 20, 0.9, 1e-4, 1e-6)
    assert pst.poly_lr_factor(*args) == jst.poly_lr_factor(*args)


# name: (config, the 3 steps' learning rates). Adam at the pretrain
# config's 1e-4; RMSprop's first step moves every parameter by ~10·lr
# (g / sqrt(0.01·g²)), so it runs at 1e-5 to take steps of Adam's size
OPTIMIZERS = {
    "Adam": ({"name": "Adam", "lr": 1e-4}, [1e-4, 8e-5, 6e-5]),
    "SGD": ({"name": "SGD", "lr": 1e-2,
             "sgd_cfg": {"weight_decay": 1e-3, "momentum": 0.9}},
            [1e-2, 8e-3, 6e-3]),
    "Adadelta": ({"name": "Adadelta", "lr": 1.0}, [1.0, 0.8, 0.6]),
    "RMSprop": ({"name": "RMSprop", "lr": 1e-5}, [1e-5, 8e-6, 6e-6]),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_optax_on_the_same_gradients(name):
    """make_seg_optimizer's torch optimizer against the JAX package's optax
    one, fed the same 3 gradients at the same learning rates (10× the
    table's, so that weight decay and momentum move the parameters
    visibly): every parameter within 1e-6 relative of its largest
    magnitude after each step."""
    cfg, lrs = OPTIMIZERS[name]
    rng = np.random.default_rng(10)
    shapes = {"a": (6, 4, 3, 3), "b": (7,), "c": (5, 9)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jst.make_seg_optimizer(cfg)
    opt_state = tx.init(params)
    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    opt = pst.make_seg_optimizer(list(tensors.values()), cfg)
    for lr in lrs:
        grads = {k: rng.normal(size=s).astype(np.float32)
                 * rng.uniform(1e-3, 1) for k, s in shapes.items()}
        opt_state.hyperparams["learning_rate"] = jnp.float32(10 * lr)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k])
        for group in opt.param_groups:
            group["lr"] = 10 * lr
        opt.step()
        for k, t in tensors.items():
            assert rel_err(t.detach().numpy(), params[k]) < 1e-6, (name, k)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_steps_match_jax(setup, name):
    """3 train_steps (learning rates set per step, as the POLY schedule
    does; SGD with the double softmax; the last step with n_real = 1 of
    the 2 images) against the JAX package's make_seg_optimizer from the
    same state: each step's loss within 1e-5 relative, its confusion
    matrix the JAX one's but for argmaxes that flip at near-ties (the same
    total, at most 0.2 % of the pixels moved), the running stats within
    1e-4 relative, every parameter element within 1e-3 of its tensor's
    largest magnitude and at least 99.9 % of all elements within 1e-5.
    Adam and RMSprop divide a gradient by its own size, so an element
    whose gradient sits at rounding level steps by ±lr on a sign that
    rounding picks: those few elements are the ones past 1e-5."""
    jm, params, stats, images, labels, loss_and_grad = setup
    cfg, lrs = OPTIMIZERS[name]
    double_softmax = name == "SGD"
    tx = jst.make_seg_optimizer(cfg)
    opt_state = tx.init(params)
    j_params, j_stats = params, stats
    trainer = port_trainer(params, stats, cfg, double_softmax)
    for step, lr in enumerate(lrs):
        n_real = 1 if step == 2 else None
        denom = jnp.float32((n_real or 2) * H * W)
        (loss, (j_stats, logits)), grads = loss_and_grad(
            j_params, j_stats, jnp.asarray(images), jnp.asarray(labels),
            denom, double_softmax)
        opt_state.hyperparams["learning_rate"] = jnp.float32(lr)
        updates, opt_state = tx.update(grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        conf_ref = confusion_matrix_update(jnp.argmax(logits, -1),
                                           jnp.asarray(labels), 5)
        p_loss, p_conf = trainer.train_step(
            torch.from_numpy(images), torch.from_numpy(labels), lr,
            torch.Generator(), n_real=n_real)
        assert float(p_loss) == pytest.approx(float(loss), rel=1e-5)
        conf_ref = np.asarray(conf_ref)
        moved = np.abs(p_conf.numpy() - conf_ref).sum() / 2
        assert p_conf.numpy().sum() == conf_ref.sum()
        assert moved <= 2e-3 * conf_ref.sum()
    ref = deeplab_state_from_jax(j_params, j_stats)
    state = trainer.model.state_dict()
    n_past, n = 0, 0
    for k, r in ref.items():
        if "running" in k:
            assert rel_err(state[k].numpy(), r.numpy()) < 1e-4, k
        elif "num_batches" not in k:
            err = (state[k] - r).abs() / r.abs().max()
            assert float(err.max()) < 1e-3, k
            n_past += int((err > 1e-5).sum())
            n += err.numel()
    assert n_past <= 1e-3 * n


def test_eval_step_and_infer_match_jax(setup):
    """eval_step (running stats) → preds equal and logits within 1e-4 of
    the JAX eval step's; infer with update_bn (the BN trick) → the JAX
    joint trainer's composition (use_running_average=False,
    deterministic=True, softmax): probs within 1e-5, preds equal, running
    stats within 1e-5 relative; infer without it is eval mode and leaves
    them."""
    jm, params, stats, images, _, _ = setup
    trainer = port_trainer(params, stats, {"name": "Adam", "lr": 1e-3})
    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("float32"):
        out = jm.apply(variables, jnp.asarray(images))["out"]
        trick, mutated = jm.apply(variables, jnp.asarray(images),
                                  use_running_average=False,
                                  deterministic=True,
                                  mutable=["batch_stats"])
    preds, logits = trainer.eval_step(torch.from_numpy(images))
    assert rel_err(to_nhwc(logits), out) < 1e-4
    np.testing.assert_array_equal(preds.numpy(), np.asarray(
        jnp.argmax(jax.nn.softmax(out, -1), -1)))
    preds, probs = trainer.infer(torch.from_numpy(images))
    assert rel_err(to_nhwc(probs), jax.nn.softmax(out, -1)) < 1e-5
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    preds, probs = trainer.infer(torch.from_numpy(images), update_bn=True)
    ref_probs = jax.nn.softmax(trick["out"], -1)
    assert rel_err(to_nhwc(probs), ref_probs) < 1e-5
    np.testing.assert_array_equal(preds.numpy(),
                                  np.asarray(jnp.argmax(ref_probs, -1)))
    ref = deeplab_state_from_jax(params, mutated["batch_stats"])
    state = trainer.model.state_dict()
    for k in ref:
        if "running" in k:
            assert rel_err(state[k].numpy(), ref[k].numpy()) < 1e-5, k
            assert not torch.equal(state[k], before[k]), k
    assert not trainer.model.classifier[0].dropout.training


def test_make_seg_optimizer_rejects_unknown_names():
    model = DeepLabV3(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        pst.make_seg_optimizer(model.parameters(), {"name": "Lion",
                                                    "lr": 1e-3})
    opt = pst.make_seg_optimizer(model.parameters(),
                                 {"name": "SGD", "base_lr": 0.5},
                                 lr_key="base_lr")
    assert opt.param_groups[0]["lr"] == 0.5
    assert opt.param_groups[0]["momentum"] == 0.9
    assert opt.param_groups[0]["weight_decay"] == 0.0
