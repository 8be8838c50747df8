"""The port's Semantic-NeRF MLPs against the JAX package's, on the CPU.

The three `_FusedStyleMLP` shapes of SemanticNeRF — sigma 32 → 64 → 16,
color 31 → 64 → 64 → 3 and semantics 15 → 64 → C (C = 6 here) — with
lecun-normal weights from flax's init carried across by params_from_jax,
and numpy-seeded inputs and cotangents. On CPU tensors the wrappers
mlp_fwd / mlp_bwd take their plain versions, which the CUDA kernels are
held to on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances. Both sides compute every layer in bf16 with f32 accumulation
and one rounding, but sum in other orders, so an element may round to the
other bf16 neighbour (1 ulp = 2^-8 of its magnitude), and a hidden value
that did so moves the next layer's outputs by a fraction of an ulp of the
row's scale:
  * forward, dx: |diff| <= 2^-7 · the row's largest |value| (two ulps of
    the row's scale), and at least 0.99 of the elements bit-equal;
  * dW (summed over all N points in f32, rounded to bf16 once): |diff| <=
    2^-7 · |value| + 2^-12 · the layer's largest |value| (an ulp of the
    element, plus a floor for the near-zero sums where cancellation leaves
    only the last bits of the sum), and at least 0.99 bit-equal.
Against jax.vjp at these inputs all but one dx element (of 15,000) and one
dW element (of 2,048) are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu.models import SemanticNeRF as JNeRF
from ucsa_neural_rendering_tpu.models.semantic_nerf import \
    _FusedStyleMLP as JMLP
from ucsa_neural_rendering_tpu_torch.models import (SemanticNeRF,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as tsn

N = 1000
C = 6
# (name, JAX module, input width) of the three MLPs of SemanticNeRF(8 × 4)
NETS = (("sigma_net", JMLP(64, 1, 16), 32),
        ("color_net", JMLP(64, 2, 3), 31),
        ("semantics_net", JMLP(64, 1, C), 15))


@pytest.fixture(scope="module")
def models():
    """A JAX SemanticNeRF's params and the port's model loaded from them."""
    kw = dict(bound=1.0, num_semantic_classes=C, n_levels=8, n_features=4,
              log2_hashmap_size=12)
    jm = JNeRF(**kw)
    x = jnp.zeros((4, 3))
    d = jnp.zeros((4, 3)).at[:, 2].set(1.0)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), x, d)["params"])
    tm = SemanticNeRF(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return params, tm


def _inputs(seed, d_in, d_out):
    """x [N, d_in] and the cotangent [N, d_out], bf16-valued f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d_in)).astype(np.float32)
    g = rng.normal(size=(N, d_out)).astype(np.float32)
    rnd = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return rnd(x), rnd(g)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _assert_rows_close(out, ref, min_equal=0.99):
    """|diff| within two bf16 ulps of each row's largest |value|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    diff = np.abs(out - ref)
    assert (diff <= 2.0 ** -7 * scale).all(), (diff / scale).max()
    assert (diff == 0).mean() >= min_equal, (diff == 0).mean()


def _assert_dw_close(out, ref):
    """Per element an ulp of its magnitude, plus 2^-12 of the layer's
    largest |value|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    diff = np.abs(out - ref)
    tol = 2.0 ** -7 * np.abs(ref) + 2.0 ** -12 * np.abs(ref).max()
    assert (diff <= tol).all(), (diff - tol).max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def _layer_weights(tm, name):
    return [lin.weight for lin in getattr(tm, name).layers]


@pytest.mark.parametrize("net", range(3), ids=[n[0] for n in NETS])
def test_mlp_fwd_matches_flax(models, net):
    """The module's forward (mlp_fwd's CPU route) against flax apply."""
    params, tm = models
    name, jmlp, d_in = NETS[net]
    x, _ = _inputs(net, d_in, 1)
    ref = np.asarray(jax.jit(lambda p, x: jmlp.apply({"params": p}, x))(
        params[name], x).astype(jnp.float32))
    with torch.no_grad():
        out = getattr(tm, name)(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    _assert_rows_close(out.float().numpy(), ref)
    torch.testing.assert_close(
        out, tsn.mlp_fwd(torch.from_numpy(x), _layer_weights(tm, name)),
        rtol=0, atol=0)


@pytest.mark.parametrize("net", range(3), ids=[n[0] for n in NETS])
def test_mlp_bwd_plain_matches_jax_vjp(models, net):
    """dx and every layer's dW against jax.vjp of the flax MLP, with respect
    to its bf16 input and its f32 kernels, for a seeded bf16 cotangent."""
    params, tm = models
    name, jmlp, d_in = NETS[net]
    d_out = _layer_weights(tm, name)[-1].shape[0]
    x, g = _inputs(10 + net, d_in, d_out)

    @jax.jit
    def vjp(p, x, g):
        _, f = jax.vjp(lambda p, x: jmlp.apply({"params": p}, x), p, x)
        return f(g)

    jdp, jdx = vjp(params[name], jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(g, jnp.bfloat16))
    dx, dws = tsn.mlp_bwd_plain(_bf16(x), _layer_weights(tm, name), _bf16(g))
    assert dx.dtype == torch.bfloat16 and jdx.dtype == jnp.bfloat16
    _assert_rows_close(dx.float().numpy(), np.asarray(jdx, np.float32))
    assert len(dws) == len(jdp)
    for i, dw in enumerate(dws):
        assert dw.dtype == torch.float32
        # the widened bf16 sum: exactly representable in bf16
        assert torch.equal(dw, dw.to(torch.bfloat16).float())
        _assert_dw_close(dw.numpy(), np.asarray(jdp[f"Dense_{i}"]["kernel"]).T)


@pytest.mark.parametrize("net", range(3), ids=[n[0] for n in NETS])
def test_mlp_function_matches_torch_autograd(models, net):
    """The module's autograd Function (forward mlp_fwd, backward mlp_bwd)
    against torch autograd of the torch.matmul chain: the same forward bit
    for bit, gradients to the tolerances above."""
    _, tm = models
    name, _, d_in = NETS[net]
    mlp = getattr(tm, name)
    d_out = mlp.layers[-1].weight.shape[0]
    x, g = _inputs(20 + net, d_in, d_out)
    xa = torch.from_numpy(x).requires_grad_()
    mlp.zero_grad(set_to_none=True)
    out = mlp(xa)
    out.backward(_bf16(g))
    xb = torch.from_numpy(x).requires_grad_()
    ws = [w.detach().clone().requires_grad_() for w in _layer_weights(tm,
                                                                      name)]
    ref = tsn.mlp_fwd_plain(xb, ws)
    ref.backward(_bf16(g))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert xa.grad.dtype == torch.float32  # through the input's bf16 cast
    _assert_rows_close(xa.grad.numpy(), xb.grad.numpy())
    for lin, w in zip(mlp.layers, ws):
        _assert_dw_close(lin.weight.grad.numpy(), w.grad.numpy())


def test_mlp_ragged_and_strided_input():
    """A column slice (the semantics net reads the sigma output's geo
    features in place) and N = 1 give the contiguous copy's results; the
    ReLU mask passes gradient only where the activation is > 0."""
    g = torch.Generator().manual_seed(3)
    ws = [torch.randn((64, 15), generator=g) * 0.3,
          torch.randn((5, 64), generator=g) * 0.1]
    ws[0][0] = 0.0  # hidden unit 0 is 0 at every point
    h = torch.randn((77, 16), generator=g).to(torch.bfloat16)
    x = h[:, 1:]
    assert not x.is_contiguous()
    y = tsn.mlp_fwd(x, ws)
    torch.testing.assert_close(y, tsn.mlp_fwd(x.contiguous(), ws), rtol=0,
                               atol=0)
    torch.testing.assert_close(y[:1], tsn.mlp_fwd(x[:1], ws), rtol=0, atol=0)
    dy = torch.randn((77, 5), generator=g).to(torch.bfloat16)
    dx, (dw0, dw1) = tsn.mlp_bwd(x, ws, dy)
    hidden = torch.relu(torch.matmul(x, ws[0].to(torch.bfloat16).t()))
    assert (hidden == 0).any() and (hidden > 0).any()
    # a hidden unit that is 0 at every point passes no gradient to W_0
    assert (hidden[:, 0] == 0).all() and not dw0[0].any()
    ref = torch.matmul(dy.float().t(), hidden.float()).to(torch.bfloat16)
    torch.testing.assert_close(dw1, ref.float(), rtol=0, atol=0)
    assert dx.shape == (77, 15) and dx.dtype == torch.bfloat16
