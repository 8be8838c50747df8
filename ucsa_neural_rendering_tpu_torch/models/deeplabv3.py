"""DeepLabV3 (ResNet-101, output stride 8) segmentation model, NCHW
(counterpart of ucsa_neural_rendering_tpu/models/deeplabv3.py).

torchvision's `deeplabv3_resnet101` with the aux head dropped, as the
reference loads it: ASPP (1×1, atrous 12/24/36, image pooling), project,
dropout 0.5, then 3×3 conv, BN, ReLU and a 1×1 classifier with bias; the
logits are upsampled bilinearly with half-pixel centers
(align_corners=False) in f32. Attribute names are torchvision's
(`backbone.*`, `classifier.0.convs.{0..3}.{0,1}`, `classifier.0.convs.4.{1,2}`,
`classifier.0.project.{0,1}`, `classifier.1`, `classifier.2`,
`classifier.4`), so `state_dict()` keys are a released checkpoint's without
its `aux_classifier.*`.

Modes. The JAX model takes two flags, `use_running_average` (BN running
stats, no update) and `deterministic` (dropout off). Here BN modules follow
their `training` flag and the dropout module its own, as in torch:
  * JAX train (False, False)  = `model.train()`;
  * JAX eval  (True, True)    = `model.eval()`;
  * the BN trick (False, True: BN batch stats with updates, dropout off,
    JAX `train/joint_trainer.py:250-266`) = `model.set_mode(
    use_running_average=False, deterministic=True)`, which is the
    reference's `model.eval()` followed by `.train()` on every BN module.
`set_mode` takes any of the four pairs. Dropout, when on, draws its mask
from the `generator` passed to `forward` (the JAX package's dropout key),
never from the global RNG.

compute_dtype (the JAX package's `dtype`, from `model.compute_dtype` by
`seg_compute_dtype`): the input is cast to it and every convolution, BN
normalization, ReLU and the dropout run in it (models/resnet.py), while
the parameters, the BN statistics, the image-pooling mean (accumulated in
f32), the bilinear upsample and the loss stay f32; the same f32 state dict
loads into either.
"""

import contextlib

import torch
from torch import nn

from ..parallel.mesh import batch_mesh
from ..utils.device import resolve_device
from .resnet import (RESNET101_LAYOUT, BatchNorm2d, ResNet101Backbone,
                     conv2d, is_low_precision)


def seg_compute_dtype(model_cfg: dict | None = None) -> torch.dtype:
    """The seg net's compute dtype from `exp["model"]["compute_dtype"]`
    (the JAX package's seg_compute_dtype): float32 when absent, else the
    torch floating dtype of that name (e.g. "bfloat16"); ValueError for
    any other name."""
    name = (model_cfg or {}).get("compute_dtype")
    if name is None:
        return torch.float32
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"model.compute_dtype: {name!r} is not a torch "
                         f"floating dtype")
    return dtype


class GlobalMeanPool(nn.Module):
    """The image-pooling branch's global mean [B, C, h, w] → [B, C, 1, 1],
    as the JAX package's jnp.mean: a mean over (h, w), whose backward
    spreads the gradient evenly (no atomics: the same bits every run on
    the card); a lower-precision input accumulates in f32 and returns in
    its dtype (a ~1.2k-element sum loses mass in bf16)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not is_low_precision(x.dtype):
            return x.mean(dim=(2, 3), keepdim=True)
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


class Dropout(nn.Module):
    """Dropout as flax computes it: keep with probability 1 − p, scale the
    kept values by 1 / (1 − p). The mask is drawn on the generator's device
    and moved to x's, so a CPU generator gives the same mask on any
    device. Inside `parallel.sharded_batch(mesh)` x is this rank's block
    of a batch sharded over the mesh: the mask of the global batch is
    drawn (every rank draws the same) and this rank's block kept, so the
    ranks together drop what one rank drops on the whole batch."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout is on: pass a torch.Generator")
        keep_prob = 1.0 - self.p
        mesh = batch_mesh()
        if mesh is None:
            u = torch.rand(x.shape, generator=generator,
                           device=generator.device)
        else:
            b = x.shape[0]
            u = torch.rand((b * mesh.size, *x.shape[1:]), generator=generator,
                           device=generator.device)[mesh.block(b * mesh.size)]
        keep = (u < keep_prob).to(x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling, rates (12, 24, 36) at output
    stride 8."""

    def __init__(self, in_channels: int, out_channels: int, generator,
                 atrous_rates: tuple = (12, 24, 36)):
        super().__init__()
        branches = [nn.Sequential(
            conv2d(in_channels, out_channels, 1, generator),
            BatchNorm2d(out_channels), nn.ReLU())]
        branches += [nn.Sequential(
            conv2d(in_channels, out_channels, 3, generator, dilation=rate),
            BatchNorm2d(out_channels), nn.ReLU()) for rate in atrous_rates]
        # image pooling: the global mean, 1×1 conv, BN, ReLU, then
        # broadcast back over the feature map
        branches.append(nn.Sequential(
            GlobalMeanPool(),
            conv2d(in_channels, out_channels, 1, generator),
            BatchNorm2d(out_channels), nn.ReLU()))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(
            conv2d(len(branches) * out_channels, out_channels, 1, generator),
            BatchNorm2d(out_channels), nn.ReLU())
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        outs = [branch(x) for branch in self.convs[:-1]]
        outs.append(self.convs[-1](x).expand(-1, -1, *x.shape[-2:]))
        return self.dropout(self.project(torch.cat(outs, dim=1)), generator)


@contextlib.contextmanager
def _f32_matmul():
    """Products in full f32 within this block, whatever the caller set
    (TF32 off)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


_RESIZE_WEIGHTS = {}


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] f32 weights of one axis of a bilinear resize, as
    jax.image.resize's compute_weight_mat makes them for method "bilinear"
    (scale n_out / n_in, translation 0): the triangle kernel at half-pixel
    centers, widened by 1 / scale when the axis shrinks (JAX's default
    antialias; it changes nothing on the upsample), each column divided by
    its sum, and columns whose sample lies outside [-0.5, n_in - 0.5] zero.
    Made on the CPU, so any device gets the same bits; kept per (n_in,
    n_out, device)."""
    key = (n_in, n_out, str(device))
    if key not in _RESIZE_WEIGHTS:
        f32 = torch.float32
        inv_scale = 1.0 / (n_out / n_in)
        sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
        x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
        x = x / max(inv_scale, 1.0)
        w = torch.clamp(1.0 - x, min=0.0)
        total = w.sum(0, keepdim=True)
        w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                        w / torch.where(total != 0, total, 1.0),
                        torch.zeros_like(w))
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        w = torch.where(inside[None, :], w, torch.zeros_like(w))
        _RESIZE_WEIGHTS[key] = w.to(device)
    return _RESIZE_WEIGHTS[key]


class _Resize(torch.autograd.Function):
    """x [B, C, h, w] → Wh^T · x · Ww, its backward Wh · g · Ww^T: two f32
    matrix products each way (no atomics, the same bits every run on the
    card)."""

    @staticmethod
    def forward(ctx, x, wh, ww):
        ctx.save_for_backward(wh, ww)
        with _f32_matmul():
            return torch.matmul(wh.t(), torch.matmul(x, ww))

    @staticmethod
    def backward(ctx, g):
        wh, ww = ctx.saved_tensors
        with _f32_matmul():
            return torch.matmul(wh, torch.matmul(g, ww.t())), None, None


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of [B, C, h, w] with half-pixel centers, as the JAX
    package's jax.image.resize computes it: the input contracted with one
    interpolation-weight matrix per axis (resize_weights) in f32, TF32 off;
    forward and backward are matrix products. An axis whose size does not
    change is left alone, as there."""
    h, w = x.shape[-2:]
    out_h, out_w = (int(v) for v in out_hw)
    if (h, w) == (out_h, out_w):
        return x
    wh, ww = (resize_weights(n, m, x.device) if n != m
              else torch.eye(n, device=x.device)
              for n, m in ((h, out_h), (w, out_w)))
    return _Resize.apply(x, wh.to(x.dtype), ww.to(x.dtype))


class DeepLabV3(nn.Module):
    """x [B, 3, H, W] in [0, 1] (the reference feeds unnormalized 0–1
    images) → {"out": logits [B, num_classes, H, W] f32}.

    backbone_layout = TINY_LAYOUT and small widths give the same graph at a
    fraction of the operations (tests). compute_dtype: see the module's
    docstring (the logits leave f32 either way; None: the input's dtype,
    e.g. f64 for a model made .double()). Init draws from `generator` (a
    CPU torch.Generator, so a seed gives the same weights on any device;
    seed 0 when none is given); see models.convert.deeplab_state_from_jax
    for the JAX package's weights and load_deeplab_checkpoint for a
    torchvision or Lightning checkpoint."""

    def __init__(self, num_classes: int = 40,
                 backbone_layout: tuple = RESNET101_LAYOUT,
                 aspp_channels: int = 256, head_channels: int = 256,
                 device="cuda", generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.backbone = ResNet101Backbone(backbone_layout, "cpu", generator)
        self.classifier = nn.Sequential(
            ASPP(self.backbone.out_channels, aspp_channels, generator),
            conv2d(aspp_channels, head_channels, 3, generator),
            BatchNorm2d(head_channels), nn.ReLU(),
            conv2d(head_channels, num_classes, 1, generator, bias=True))
        self.to(device)

    def set_mode(self, use_running_average: bool, deterministic: bool):
        """The JAX model's two flags: BN modules train (batch stats, running
        stats updated) unless use_running_average; dropout is on unless
        deterministic. Returns self."""
        self.train(not use_running_average)
        for m in self.modules():
            if isinstance(m, Dropout):
                m.train(not deterministic)
        return self

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> dict:
        aspp, *head = self.classifier
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        h = aspp(self.backbone(x), generator)
        for m in head:
            h = m(h)
        return {"out": resize_bilinear(h.float(), x.shape[-2:])}
