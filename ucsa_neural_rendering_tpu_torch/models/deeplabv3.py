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
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .resnet import (RESNET101_LAYOUT, BatchNorm2d, ResNet101Backbone,
                     conv2d)


class Dropout(nn.Module):
    """Dropout as flax computes it: keep with probability 1 − p, scale the
    kept values by 1 / (1 − p). The mask is drawn on the generator's device
    and moved to x's, so a CPU generator gives the same mask on any
    device."""

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
        u = torch.rand(x.shape, generator=generator,
                       device=generator.device)
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
            nn.AdaptiveAvgPool2d(1),
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


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of [B, C, h, w] with half-pixel centers
    (align_corners=False), the JAX package's jax.image.resize."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


class DeepLabV3(nn.Module):
    """x [B, 3, H, W] in [0, 1] (the reference feeds unnormalized 0–1
    images) → {"out": logits [B, num_classes, H, W] f32}.

    backbone_layout = TINY_LAYOUT and small widths give the same graph at a
    fraction of the operations (tests). Init draws from `generator` (a CPU
    torch.Generator, so a seed gives the same weights on any device; seed 0
    when none is given); see models.convert.deeplab_state_from_jax for the
    JAX package's weights and load_deeplab_checkpoint for a torchvision or
    Lightning checkpoint."""

    def __init__(self, num_classes: int = 40,
                 backbone_layout: tuple = RESNET101_LAYOUT,
                 aspp_channels: int = 256, head_channels: int = 256,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_classes = num_classes
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
        h = aspp(self.backbone(x), generator)
        for m in head:
            h = m(h)
        return {"out": resize_bilinear(h.float(), x.shape[-2:])}
