"""Semantic-NeRF network: hash encoding + sigma / color / semantics MLPs
(counterpart of ucsa_neural_rendering_tpu/models/semantic_nerf.py).

The MLPs are bias-free ReLU stacks computed in bf16 from f32 parameters
with `torch.matmul` (the JAX package leaves them to XLA as plain
`nn.Dense`); a fused MLP kernel is later work.
"""

import math

import torch
from torch import nn

from ..utils.device import resolve_device
from .activation import trunc_exp
from .hash_encoding import HashGridEncoding, make_spec, ngp_per_level_scale
from .sh_encoding import sh_encoding


class _FusedStyleMLP(nn.Module):
    """Bias-free ReLU MLP: n_hidden_layers hidden layers of `width`, linear
    output; bf16 compute over f32 weights. Weights init like flax's
    lecun_normal (truncated normal, variance 1/fan_in)."""

    def __init__(self, in_dim: int, width: int, n_hidden_layers: int,
                 out_dim: int, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
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
        x = x.to(torch.bfloat16)
        for lin in self.layers[:-1]:
            x = torch.relu(torch.matmul(x, lin.weight.to(torch.bfloat16).t()))
        return torch.matmul(x, self.layers[-1].weight.to(torch.bfloat16).t())


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
                 table_init_range: float = 1e-4):
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
        self.encoder = HashGridEncoding(self.grid_spec(), device, generator,
                                        table_init_range)
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
        bf16)."""
        x01 = (x + self.bound) / (2.0 * self.bound)
        h = self.sigma_net(self.encoder(x01))
        return trunc_exp(h[..., 0]), h[..., 1:]

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
