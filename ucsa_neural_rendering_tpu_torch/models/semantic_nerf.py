"""Semantic-NeRF network: hash encoding + sigma / color / semantics MLPs
(counterpart of ucsa_neural_rendering_tpu/models/semantic_nerf.py).

The MLPs are bias-free ReLU stacks computed in bf16 from f32 parameters
(the JAX package's `nn.Dense` layers in bf16). `mlp_fwd` wraps the fused
forward kernel (csrc/mlp_fwd.cu) and `mlp_bwd` its VJP (csrc/mlp_bwd.cu);
`mlp_fwd_plain` and `mlp_bwd_plain` are the same functions in plain
PyTorch, taken for CPU tensors. An MLP runs through `_MLP`, whose forward
is mlp_fwd and whose backward is mlp_bwd, when grad is enabled, and through
mlp_fwd alone under no_grad (the render and the occupancy refresh).
"""

import math

import torch
from torch import nn

from .. import kernels
from ..utils.device import resolve_device
from .activation import trunc_exp
from .hash_encoding import HashGridEncoding, make_spec, ngp_per_level_scale
from .sh_encoding import sh_encoding

# the kernels' limits (csrc/mlp.cuh): layers and width of any layer; points
# per block tile (16 a warp) and blocks per SM of the forward (mlp_fwd.cu:
# persistent blocks of 8 warps) and of the backward (mlp_bwd.cu: persistent
# blocks of 4 warps)
_MAX_LAYERS, _MAX_DIM = 3, 64
_FWD_TILE_ROWS, _FWD_BLOCKS_PER_SM = 128, 2
_BWD_TILE_ROWS, _BWD_BLOCKS_PER_SM = 64, 2


def mlp_fwd_plain(x: torch.Tensor, weights) -> torch.Tensor:
    """Plain version of the mlp_fwd kernel: x [N, d0] (cast to bf16) through
    the bias-free ReLU stack of the f32 weights [d_{l+1}, d_l], each layer a
    bf16 torch.matmul (f32 accumulation, one rounding) → [N, d_L] bf16."""
    x = x.to(torch.bfloat16)
    for w in weights[:-1]:
        x = torch.relu(torch.matmul(x, w.to(torch.bfloat16).t()))
    return torch.matmul(x, weights[-1].to(torch.bfloat16).t())


def mlp_bwd_plain(x: torch.Tensor, weights, dy: torch.Tensor):
    """Plain version of the mlp_bwd kernel: the VJP of mlp_fwd_plain at x
    for the output cotangent dy [N, d_L] (bf16), written out step by step
    with the rounding points of JAX's autodiff through bf16 `Dense` layers:
    per layer from the last, dW = bf16(gᵀ·h) summed over all N in f32 and
    widened to f32 (the f32 → bf16 cast's VJP), dh = bf16(g·W), and the
    next g = dh where the layer's input h > 0. The f32 matmuls of bf16
    values have exact products, so each rounds once. Returns (dx [N, d0]
    bf16, [dW_l f32 [d_{l+1}, d_l]])."""
    wb = [w.detach().to(torch.bfloat16) for w in weights]
    hs = [x.detach().to(torch.bfloat16)]
    for w in wb[:-1]:
        hs.append(torch.relu(torch.matmul(hs[-1], w.t())))
    g = dy.to(torch.bfloat16)
    dws = [None] * len(wb)
    for lvl in reversed(range(len(wb))):
        dws[lvl] = torch.matmul(g.t().float(), hs[lvl].float()).to(
            torch.bfloat16).float()
        dh = torch.matmul(g.float(), wb[lvl].float()).to(torch.bfloat16)
        g = torch.where(hs[lvl] > 0, dh, torch.zeros_like(dh)) if lvl else dh
    return g, dws


def _check_mlp(x: torch.Tensor, weights) -> list[int]:
    """Raise unless the kernels take this x and these weights; returns the
    widths [d0, ..., d_L]."""
    if not 1 <= len(weights) <= _MAX_LAYERS:
        raise ValueError(f"the MLP kernels take 1 to {_MAX_LAYERS} layers, "
                         f"got {len(weights)}")
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.ndim != 2:
        raise ValueError(f"x: expected a 2-D bf16 CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.shape[0] > 1 and (x.stride(1) != 1 or x.stride(0) < x.shape[1]):
        raise ValueError(f"x: rows must be contiguous, strides {x.stride()}")
    dims = [x.shape[1]] + [w.shape[0] for w in weights]
    for lvl, w in enumerate(weights):
        kernels.check(w, f"weights[{lvl}]", torch.float32,
                      (dims[lvl + 1], dims[lvl]), x.device)
    if max(dims) > _MAX_DIM:
        raise ValueError(f"the MLP kernels take widths up to {_MAX_DIM}, "
                         f"got {dims}")
    return dims


def _launch_args(x, weights, dims):
    """x with its row stride, the weights padded to _MAX_LAYERS with NULL,
    and (after the caller's own arguments) the depth and widths."""
    ws = list(weights) + [None] * (_MAX_LAYERS - len(weights))
    widths = dims + [0] * (_MAX_LAYERS + 1 - len(dims))
    return [x, x.stride(0)], ws, [len(weights), *widths]


def _blocks(n: int, device, rows: int, per_sm: int) -> int:
    return max(1, min(-(-n // rows), per_sm * kernels.sm_count(device)))


def mlp_fwd(x: torch.Tensor, weights) -> torch.Tensor:
    """x [N, d0] bf16 (rows contiguous; a column slice is read in place),
    weights: f32 [d_{l+1}, d_l] per layer → [N, d_L] bf16, as
    mlp_fwd_plain. CUDA tensors launch mlp_fwd; CPU tensors take the plain
    version."""
    if not x.is_cuda:
        return mlp_fwd_plain(x, weights)
    dims = _check_mlp(x, weights)
    n = x.shape[0]
    y = torch.empty((n, dims[-1]), dtype=torch.bfloat16, device=x.device)
    if n:
        xa, ws, shape = _launch_args(x, weights, dims)
        kernels.launch("mlp_fwd", *xa, *ws, y, n,
                       _blocks(n, x.device, _FWD_TILE_ROWS,
                               _FWD_BLOCKS_PER_SM), *shape)
    return y


def mlp_bwd(x: torch.Tensor, weights, dy: torch.Tensor):
    """The VJP of mlp_fwd: x and weights as mlp_fwd's, dy [N, d_L] bf16 →
    (dx [N, d0] bf16, [dW_l f32 [d_{l+1}, d_l]]), as mlp_bwd_plain. CUDA
    tensors launch mlp_bwd (per-block partial dW summed by a second pass in
    a fixed order: the same bits from run to run); CPU tensors take the
    plain version."""
    if not x.is_cuda:
        return mlp_bwd_plain(x, weights, dy)
    dims = _check_mlp(x, weights)
    n, dev = x.shape[0], x.device
    kernels.check(dy, "dy", torch.bfloat16, (n, dims[-1]), dev)
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    dx = torch.empty((n, dims[0]), dtype=torch.bfloat16, device=dev)
    if n:
        blocks = _blocks(n, dev, _BWD_TILE_ROWS, _BWD_BLOCKS_PER_SM)
        partial = torch.empty((blocks, sum(sizes)), dtype=torch.float32,
                              device=dev)
        dw = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
        xa, ws, shape = _launch_args(x, weights, dims)
        kernels.launch("mlp_bwd", *xa, dy, *ws, dx, partial, dw, n, blocks,
                       *shape)
    else:
        dw = torch.zeros((sum(sizes),), dtype=torch.float32, device=dev)
    return dx, [t.view(b, a) for t, a, b in zip(torch.split(dw, sizes),
                                                 dims[:-1], dims[1:])]


class _MLP(torch.autograd.Function):
    """The MLP with mlp_fwd as its forward and mlp_bwd as its backward; the
    backward recomputes the hidden activations from the saved input."""

    @staticmethod
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        return mlp_fwd(x, weights)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        dx, dws = mlp_bwd(x, weights, dy.to(torch.bfloat16).contiguous())
        return dx, *dws


class _FusedStyleMLP(nn.Module):
    """Bias-free ReLU MLP: n_hidden_layers hidden layers of `width`, linear
    output; bf16 compute over f32 weights. Weights init like flax's
    lecun_normal (truncated normal, variance 1/fan_in)."""

    def __init__(self, in_dim: int, width: int, n_hidden_layers: int,
                 out_dim: int, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dims = [in_dim] + [width] * n_hidden_layers + [out_dim]
        self.layers = nn.ModuleList()
        for a, b in zip(dims[:-1], dims[1:]):
            lin = nn.Linear(a, b, bias=False)
            # flax lecun_normal: truncated normal in ±2 std, rescaled so the
            # variance is 1/fan_in
            std = math.sqrt(1.0 / a) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            self.layers.append(lin.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, in] → [N, out] bf16; differentiable in x and the weights
        (through mlp_bwd) when grad is enabled."""
        x = x.to(torch.bfloat16)
        weights = [lin.weight for lin in self.layers]
        if torch.is_grad_enabled():
            return _MLP.apply(x, *weights)
        return mlp_fwd(x, weights)


class SemanticNeRF(nn.Module):
    """Parameters: encoder.table [T, F] f32 and the three MLPs'
    `layers.i.weight` [out, in] f32 (see models/convert.py for the mapping
    from the JAX package's parameter tree). Init draws from `generator`
    (a CPU torch.Generator; seed 0 when none is given)."""

    def __init__(self, bound: float = 4.0, num_semantic_classes: int = 40,
                 n_levels: int = 16, n_features: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 16,
                 geo_feat_dim: int = 15, hidden_dim: int = 64,
                 num_layers: int = 2, num_layers_color: int = 3,
                 hidden_dim_color: int = 64, num_layers_semantics: int = 2,
                 hidden_dim_semantics: int = 64, sh_degree: int = 4,
                 device="cuda", generator: torch.Generator | None = None,
                 table_init_range: float = 1e-4,
                 stochastic_table_grad: bool = True):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.bound = bound
        self.num_semantic_classes = num_semantic_classes
        self.n_levels = n_levels
        self.n_features = n_features
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.geo_feat_dim = geo_feat_dim
        self.sh_degree = sh_degree
        # unbiased single-corner table gradients, the JAX package's default
        self.stochastic_table_grad = stochastic_table_grad
        self.encoder = HashGridEncoding(self.grid_spec(), device, generator,
                                        table_init_range,
                                        stochastic_table_grad)
        self.sigma_net = _FusedStyleMLP(n_levels * n_features, hidden_dim,
                                        num_layers - 1, 1 + geo_feat_dim,
                                        device, generator)
        self.color_net = _FusedStyleMLP(sh_degree ** 2 + geo_feat_dim,
                                        hidden_dim_color,
                                        num_layers_color - 1, 3, device,
                                        generator)
        self.semantics_net = _FusedStyleMLP(geo_feat_dim,
                                            hidden_dim_semantics,
                                            num_layers_semantics - 1,
                                            num_semantic_classes, device,
                                            generator)

    def grid_spec(self):
        return make_spec(
            n_levels=self.n_levels, n_features=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            per_level_scale=ngp_per_level_scale(
                self.bound, self.n_levels,
                base_resolution=self.base_resolution))

    def density(self, x: torch.Tensor):
        """x [N, 3] in [-bound, bound] → (sigma [N] f32, geo_feat [N, 15]
        bf16); differentiable in the parameters when grad is enabled."""
        x01 = (x + self.bound) / (2.0 * self.bound)
        h = self.sigma_net(self.encoder(x01))
        return trunc_exp(h[..., 0]), h[..., 1:]

    def density_probe(self, x: torch.Tensor) -> torch.Tensor:
        """Density of the occupancy refresh: the single-corner sampled
        encode (8× fewer table reads) through the same sigma MLP → [N]."""
        x01 = (x + self.bound) / (2.0 * self.bound)
        h = self.sigma_net(self.encoder(x01, probe=True))
        return trunc_exp(h[..., 0])

    def color(self, d: torch.Tensor, geo_feat: torch.Tensor) -> torch.Tensor:
        """d [N, 3] unit dirs, geo_feat [N, 15] → rgb [N, 3] f32 in (0, 1)."""
        h = torch.cat([sh_encoding(d, self.sh_degree).to(torch.bfloat16),
                       geo_feat.to(torch.bfloat16)], dim=-1)
        return torch.sigmoid(self.color_net(h).float())

    def semantics(self, geo_feat: torch.Tensor) -> torch.Tensor:
        """geo_feat [N, 15] → class probabilities [N, C] (f32 softmax)."""
        return torch.softmax(self.semantics_net(geo_feat).float(), dim=-1)

    def forward(self, x: torch.Tensor, d: torch.Tensor):
        sigma, geo_feat = self.density(x)
        return sigma, self.color(d, geo_feat), self.semantics(geo_feat)
