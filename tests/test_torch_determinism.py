"""What makes the port repeat a run bit for bit on the card, held on the CPU:
the seg net's bilinear resize and image-pooling mean as the JAX package
computes them (jax.image.resize's per-axis weight matrices, jnp.mean: no
atomics in either direction on the card), and cuDNN's deterministic
algorithms set by every training entry point through one function,
utils.device.set_deterministic.

The table backward (hash_encode_bwd) sums in a fixed order on the card;
its tests need the card and are in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu.models import deeplabv3 as jdl
from ucsa_neural_rendering_tpu_torch.models import deeplabv3 as pdl
from ucsa_neural_rendering_tpu_torch.scripts import (cl_deeplab,
                                                     exp_synthetic_cl,
                                                     pretrain, train_finetune,
                                                     train_joint)
from ucsa_neural_rendering_tpu_torch.utils import device as pdevice


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# DeepLab's 8× upsample (the logits at output stride 8 back to 240×320 and
# to the gate's 120×160), a ratio that is no whole number, and one axis
# shrinking (JAX's antialiased kernel) while the other grows
RESIZE_CASES = [((30, 40), (240, 320)), ((15, 20), (120, 160)),
                ((7, 9), (33, 41)), ((24, 10), (9, 31))]


@pytest.mark.parametrize("hw, out_hw", RESIZE_CASES)
def test_resize_bilinear_and_its_vjp_match_jax(hw, out_hw):
    """Forward and backward within 1e-6 of the output's (the input
    gradient's) largest magnitude of JAX's resize_bilinear and its
    jax.vjp."""
    rng = np.random.default_rng(sum(hw) + sum(out_hw))
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    cot = rng.normal(size=(2, *out_hw, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jdl.resize_bilinear(v, out_hw),
                       jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(cot))
    ref, ref_dx = np.asarray(ref), np.asarray(ref_dx)

    xt = _nchw(x).requires_grad_(True)
    out = pdl.resize_bilinear(xt, out_hw)
    out.backward(_nchw(cot))
    got, got_dx = _nhwc(out), _nhwc(xt.grad)
    assert got.shape == ref.shape and got_dx.shape == ref_dx.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(got_dx - ref_dx).max() <= 1e-6 * np.abs(ref_dx).max()


def test_resize_weights_are_jax_weights():
    """The weight matrix of an axis is jax.image's compute_weight_mat's."""
    from jax._src.image import scale as jscale
    for n_in, n_out in ((30, 240), (7, 33), (24, 9)):
        ref = jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0,
            jscale._fill_triangle_kernel, True)
        got = pdl.resize_weights(n_in, n_out, "cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-7)


def test_resize_leaves_a_whole_axis_alone():
    """An axis that keeps its size is not resampled, as in JAX."""
    x = torch.randn(1, 2, 5, 7)
    out = pdl.resize_bilinear(x, (5, 21))
    ref = np.asarray(jdl.resize_bilinear(
        jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), (5, 21)))
    assert np.abs(_nhwc(out) - ref).max() <= 1e-6 * np.abs(ref).max()
    assert pdl.resize_bilinear(x, (5, 7)) is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_mean_pool_matches_jnp_mean(dtype):
    """The image-pooling mean and its gradient as JAX's jnp.mean over
    (h, w) in f32 (a bf16 input accumulates in f32 and returns in bf16)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 30, 40, 8)).astype(np.float32)
    cot = rng.normal(size=(2, 1, 1, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jmean(v):
        return jnp.mean(v.astype(jnp.float32), axis=(1, 2),
                        keepdims=True).astype(v.dtype)

    xj = jnp.asarray(x).astype(jdt)
    ref, vjp = jax.vjp(jmean, xj)
    (ref_dx,) = vjp(jnp.asarray(cot).astype(jdt))
    xt = _nchw(x).to(dtype).requires_grad_(True)
    out = pdl.GlobalMeanPool()(xt)
    out.backward(_nchw(cot).to(dtype))
    got = _nhwc(out.float())
    got_dx = _nhwc(xt.grad.float())
    ref = np.asarray(ref.astype(jnp.float32))
    ref_dx = np.asarray(ref_dx.astype(jnp.float32))
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    assert out.dtype == dtype and xt.grad.dtype == dtype
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    assert np.abs(got_dx - ref_dx).max() <= tol * np.abs(ref_dx).max()


@pytest.fixture
def cudnn_flags(monkeypatch):
    """Restores cuDNN's global flags after a test that sets them."""
    for name in ("deterministic", "benchmark", "allow_tf32"):
        monkeypatch.setattr(torch.backends.cudnn, name,
                            getattr(torch.backends.cudnn, name))


def test_set_deterministic_sets_cudnn_flags(cudnn_flags):
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    pdevice.set_deterministic()
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False


class _Called(Exception):
    pass


# each training entry point and the argv that reaches its set-up
CLIS = {
    "pretrain": (pretrain, ["--device", "cpu"]),
    "train_joint": (train_joint, ["--device", "cpu"]),
    "train_finetune": (train_finetune, ["--device", "cpu"]),
    "cl_deeplab": (cl_deeplab, ["--device", "cpu"]),
    "exp_synthetic_cl": (exp_synthetic_cl,
                         ["--phase", "pretrain", "--device", "cpu"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_every_training_cli_sets_cudnn_deterministic(name, monkeypatch,
                                                     cudnn_flags):
    """Each CLI calls utils.device.set_deterministic before it reads its
    experiment (the call stops the run here)."""
    module, argv = CLIS[name]
    calls = []

    def recorder():
        calls.append(name)
        raise _Called

    monkeypatch.setattr(pdevice, "set_deterministic", recorder)
    if hasattr(module, "set_deterministic"):
        monkeypatch.setattr(module, "set_deterministic", recorder)
    with pytest.raises(_Called):
        module.main(argv)
    assert calls == [name]
