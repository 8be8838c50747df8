"""ResNet-101 backbone with DeepLab's dilation (counterpart of
ucsa_neural_rendering_tpu/models/resnet.py), NCHW.

torchvision's `deeplabv3_resnet101` backbone, `replace_stride_with_dilation=
[False, True, True]` (output stride 8): layer3 keeps dilation 1 in its first
block and 2 in the rest, layer4 2 then 4. Attribute names are torchvision's
(`conv1`, `bn1`, `layer1.0.conv1`, ..., `layer1.0.downsample.0/1`), so
`state_dict()` keys are the released checkpoints' keys.

Weights init as flax's defaults, not torchvision's: lecun-normal conv
kernels (a normal truncated at ±2 std and rescaled to variance 1/fan_in),
BN scale 1, bias 0, running mean 0, var 1.

Compute dtype follows the activations (the JAX package's `dtype=` on every
conv and BN): parameters and BN statistics stay f32; on bf16 activations
the convolutions take bf16 operands (cuDNN accumulates in f32) and write
bf16, BN takes its batch statistics from an f32 copy of its input and
normalizes in bf16.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum, batch_mesh
from ..utils.device import resolve_device

# layer name → (num_blocks, planes, stride, dilation_first, dilation_rest)
RESNET101_LAYOUT = (
    ("layer1", 3, 64, 1, 1, 1),
    ("layer2", 4, 128, 2, 1, 1),
    ("layer3", 23, 256, 1, 1, 2),
    ("layer4", 3, 512, 1, 2, 4),
)

# one bottleneck per stage, 8-wide: the same graph (stem, strides,
# dilations, downsamples, BN) at ~1/30 of the operations, for tests
TINY_LAYOUT = (
    ("layer1", 1, 8, 1, 1, 1),
    ("layer2", 1, 8, 2, 1, 1),
    ("layer3", 1, 8, 1, 1, 2),
    ("layer4", 1, 8, 1, 2, 4),
)

# flax's truncated normal draws in ±2 and divides by this, the std of a
# unit normal truncated there, so that the variance is the one asked for
_TRUNC_STD = 0.87962566103423978


# the unit normal's CDF at ±2, mapped to erfinv's domain (2·cdf − 1)
_ERF_2 = math.erf(2 / math.sqrt(2))


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None):
    """flax's lecun_normal on a conv weight [O, I, kh, kw] in place:
    truncated normal, variance 1 / fan_in with fan_in = I·kh·kw. Drawn by
    inverse CDF as nn.init.trunc_normal_ draws it (which takes ~15× longer
    on a CPU)."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        weight.uniform_(-_ERF_2, _ERF_2, generator=generator)
        weight.erfinv_().mul_(std * math.sqrt(2.0))
        weight.clamp_(-2 * std, 2 * std)
    return weight


def is_low_precision(dtype: torch.dtype) -> bool:
    """Whether activations of this dtype compute as the JAX package's
    bf16 `dtype=` does (f32 statistics, f32 parameters cast down)."""
    return dtype in (torch.bfloat16, torch.float16)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose parameters are cast to the input's dtype, as flax's
    nn.Conv(dtype=...) casts its kernel: f32 inputs convolve as nn.Conv2d
    does, bf16 ones with bf16 operands."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv2d(c_in: int, c_out: int, k: int, generator, stride: int = 1,
           dilation: int = 1, bias: bool = False) -> Conv2d:
    """A conv with 'same'-style padding dilation·(k // 2), flax-initialized
    from `generator` (bias zero)."""
    # skip_init: no torch default init, no draw from the global RNG
    conv = nn.utils.skip_init(Conv2d, c_in, c_out, k, stride=stride,
                              padding=dilation * (k // 2),
                              dilation=dilation, bias=bias)
    lecun_normal_(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (momentum 0.1, eps 1e-5, normalize with the
    biased batch variance, store the unbiased one), as the JAX package's
    TorchBatchNorm computes it, with that module's behaviour at one value
    per channel in train mode: torch raises there, JAX normalizes with a
    variance of 0 (the output is the bias) and stores var·1 = 0 into the
    running variance (Bessel factor 1). The ASPP pooling branch in train
    mode at batch 1 is that case. A bf16 (or f16) input normalizes as
    TorchBatchNorm with that dtype (`_forward_low`).

    Synced BN: in train mode inside `parallel.sharded_batch(mesh)` the
    batch is sharded over the mesh's ranks, and the statistics are the
    global batch's, as JAX's global jnp.mean gives them under a sharded
    jit: the mean from the ranks' summed sums, then the centred variance
    from the ranks' summed squared deviations, both over the global n (the
    Bessel factor's n too), through a differentiable all-reduce. The f32
    and the low-precision paths both normalize from them."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def _forward_low(self, x: torch.Tensor) -> torch.Tensor:
        """A lower-precision input: batch statistics (train mode) from its
        f32 copy, the biased variance to normalize and the unbiased one
        (Bessel n / (n − 1), 1 at n = 1) into the f32 running variance;
        then (x − mean) · inv + bias in x's dtype, with inv = rsqrt(var +
        eps) · weight formed in f32."""
        if self.training:
            mean, var = self._batch_stats(x.float())
        else:
            mean, var = self.running_mean, self.running_var
        return self._normalize(x, mean, var)

    def _batch_stats(self, x32: torch.Tensor):
        """Train mode: the batch's mean and biased variance per channel
        from x32 (global over the mesh inside sharded_batch), with the
        running statistics updated (the unbiased variance, Bessel n / (n −
        1), 1 at n = 1)."""
        mesh = batch_mesh()
        n = x32.numel() // x32.shape[1]
        if mesh is None:
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32 - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        else:
            n *= mesh.size
            mean = all_reduce_sum(x32.sum(dim=(0, 2, 3)), mesh) / n
            var = all_reduce_sum((x32 - mean.view(1, -1, 1, 1)).square().sum(
                dim=(0, 2, 3)), mesh) / n
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        return mean, var

    def _normalize(self, x, mean, var):
        inv = torch.rsqrt(var + self.eps) * self.weight
        shape, dt = (1, -1, 1, 1), x.dtype
        return (x - mean.to(dt).view(shape)) * inv.to(dt).view(shape) + \
            self.bias.to(dt).view(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_low_precision(x.dtype):
            return self._forward_low(x)
        if self.training and batch_mesh() is not None:
            return self._normalize(x, *self._batch_stats(x))
        if not self.training or x.numel() != x.shape[1]:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.zeros_like(mean)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) * inv.view(shape) + \
            self.bias.view(shape)


class Bottleneck(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int,
                 dilation: int, has_downsample: bool, generator):
        super().__init__()
        self.conv1 = conv2d(in_planes, planes, 1, generator)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, generator, stride=stride,
                            dilation=dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv2d(planes, planes * 4, 1, generator)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            conv2d(in_planes, planes * 4, 1, generator, stride=stride),
            BatchNorm2d(planes * 4)) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet101Backbone(nn.Module):
    """x [B, 3, H, W] → features [B, 4·last_planes, H/8, W/8]. Stem width
    is layout[0][2]. Init draws from `generator` (a CPU torch.Generator;
    seed 0 when none is given)."""

    def __init__(self, layout: tuple = RESNET101_LAYOUT, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        stem = layout[0][2]
        self.conv1 = conv2d(3, stem, 7, generator, stride=2)
        self.bn1 = BatchNorm2d(stem)
        self.layer_names = [spec[0] for spec in layout]
        in_planes = stem
        for name, blocks, planes, stride, dil_first, dil_rest in layout:
            layer = []
            for b in range(blocks):
                first = b == 0
                layer.append(Bottleneck(
                    in_planes, planes, stride if first else 1,
                    dil_first if first else dil_rest,
                    first and (stride != 1 or in_planes != planes * 4),
                    generator))
                in_planes = planes * 4
            setattr(self, name, nn.Sequential(*layer))
        self.out_channels = in_planes
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x
