"""Image and label augmentation on the device (counterpart of
ucsa_neural_rendering_tpu/data/augmentation.py): colour jitter (brightness,
contrast, saturation 0.3, hue 0.05, in a random order per image, as
torchvision's ColorJitter), a rotation within ±degrees (bilinear image,
nearest labels, fill 0), a random crop to the output size and a horizontal
flip with probability 0.5; `only_crop` is the centre crop alone.

The random parameters come apart from the math: `draw_augment_params`
draws them from the caller's torch.Generator, one set per image, and
`augment` applies them to a batch [N, H, W, 3] at once, so a test can hand
it the JAX package's draws. Each op is plain PyTorch (no hand kernel).

Labels enter shifted +1 (0 = unknown), so that the rotation's fill 0 means
unknown; the caller shifts them back, as the JAX package and the reference
do. `host_augment` runs it on one image on the CPU for the datasets;
`rescale_to_canonical` is the datasets' host-side rescale before it
(image_io's resizes, by cv2's INTER_LINEAR and INTER_NEAREST rules).
"""

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .image_io import resize_linear, resize_nearest

GRAY = (0.299, 0.587, 0.114)


def _per_image(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N] → [N, 1, ...] broadcasting over x's trailing axes."""
    return f.reshape(-1, *([1] * (x.ndim - 1)))


def _gray(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [...]: the luma as an explicit f32 multiply-and-sum (a
    product on the card could run in TF32)."""
    return (img * img.new_tensor(GRAY)).sum(-1)


def _blend(a, b, f):
    return (f * a + (1.0 - f) * b).clamp(0.0, 1.0)


def adjust_brightness(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return (img * _per_image(f, img)).clamp(0.0, 1.0)


def adjust_contrast(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    mean = _gray(img).mean(dim=(1, 2))
    return _blend(img, _per_image(mean, img), _per_image(f, img))


def adjust_saturation(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return _blend(img, _gray(img)[..., None], _per_image(f, img))


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), 0.0)
    safe_delta = torch.where(delta > 0, delta, 1.0)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    # % takes the divisor's sign, as jnp's does
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.to(torch.int32) % 6).long()[..., None]

    def pick(*by_sector):
        return torch.stack(by_sector, dim=-1).gather(-1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def adjust_hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    hsv = _rgb_to_hsv(img.clamp(0.0, 1.0))
    h = (hsv[..., 0] + _per_image(shift, hsv[..., 0])) % 1.0
    return _hsv_to_rgb(torch.cat([h[..., None], hsv[..., 1:]], dim=-1))


JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation,
              adjust_hue)


def color_jitter(img: torch.Tensor, order: torch.Tensor,
                 factors: torch.Tensor) -> torch.Tensor:
    """img [N, H, W, 3]; order [N, 4] the index into JITTER_OPS of the op
    applied at each slot; factors [N, 4] the brightness, contrast and
    saturation factors and the hue shift. Every op runs on the whole batch
    at each slot and each image keeps its own (as JAX's lax.switch under
    vmap), so nothing waits for the host."""
    for slot in range(len(JITTER_OPS)):
        out = img
        for k, op in enumerate(JITTER_OPS):
            pick = _per_image(order[:, slot] == k, img)
            out = torch.where(pick, op(img, factors[:, k]), out)
        img = out
    return img


def _rotate(img: torch.Tensor, angle_deg: torch.Tensor, order: int,
            fill: float = 0.0) -> torch.Tensor:
    """Rotate [N, H, W, C] or [N, H, W] around each image's centre by its
    angle_deg [N]; order 1 bilinear, 0 nearest (rounding half to even);
    out-of-bounds taps → fill. The taps are gathered at explicit indices,
    as the JAX package does (no normalised grid_sample coordinates, whose
    round trip moves rounding ties)."""
    n, h, w = img.shape[:3]
    theta = -angle_deg * math.pi / 180.0  # the inverse map
    cos = theta.cos()[:, None, None]
    sin = theta.sin()[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    ys = cos * (yy - cy) - sin * (xx - cx) + cy
    xs = sin * (yy - cy) + cos * (xx - cx) + cx
    flat = img.reshape(n * h * w, -1)
    base = (torch.arange(n, device=img.device) * (h * w))[:, None, None]

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(inb[..., None], vals, fill)

    if order == 0:
        out = tap(torch.round(ys).long(), torch.round(xs).long())
    else:
        y0 = torch.floor(ys)
        x0 = torch.floor(xs)
        wy, wx = ys - y0, xs - x0
        y0, x0 = y0.long(), x0.long()
        out = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (wy if dy else 1 - wy) * (wx if dx else 1 - wx)
                out = out + wgt[..., None] * tap(y0 + dy, x0 + dx)
    return out.reshape(img.shape)


def _crop(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
          out_hw) -> torch.Tensor:
    """[N, H, W, ...] → [N, oh, ow, ...] from each image's offsets i, j
    [N]."""
    oh, ow = out_hw
    if x.shape[1:3] == (oh, ow):
        return x  # the only offsets are 0
    rows = i[:, None] + torch.arange(oh, device=x.device)
    cols = j[:, None] + torch.arange(ow, device=x.device)
    n = torch.arange(x.shape[0], device=x.device)
    return x[n[:, None, None], rows[:, :, None], cols[:, None, :]]


def draw_augment_params(generator: torch.Generator, n: int, hw,
                        out_hw=(240, 320), degrees: float = 10.0,
                        flip_p: float = 0.5,
                        jitter_bcsh=(0.3, 0.3, 0.3, 0.05),
                        device="cuda") -> dict:
    """Per image of n at size hw, drawn on the generator's device and
    returned on `device`: the jitter ops' order [N, 4] (a uniform
    permutation of 0..3), their factors [N, 4] (brightness, contrast,
    saturation in 1 ± strength, the hue shift in ± its strength), the
    angle [N] in ±degrees, the crop offsets i, j [N] (uniform over the
    valid offsets) and flip [N] bool."""
    device = resolve_device(device)
    dev = generator.device
    (h, w), (oh, ow) = hw, out_hw
    b, c, s, hue = jitter_bcsh
    low = torch.tensor([1 - b, 1 - c, 1 - s, -hue], device=dev)
    high = torch.tensor([1 + b, 1 + c, 1 + s, hue], device=dev)
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    params = {
        "order": rand(n, 4).argsort(dim=-1),
        "factors": low + (high - low) * rand(n, 4),
        "angle": degrees * (2 * rand(n) - 1),
        "i": torch.randint(0, h - oh + 1, (n,), generator=generator,
                           device=dev),
        "j": torch.randint(0, w - ow + 1, (n,), generator=generator,
                           device=dev),
        "flip": rand(n) < flip_p,
    }
    return {k: v.to(device) for k, v in params.items()}


def augment(img: torch.Tensor, labels: list, params: dict | None,
            out_hw=(240, 320), only_crop: bool = False):
    """img [N, H, W, 3] f32 in [0, 1]; labels a list of [N, H, W] float
    maps already shifted +1 (0 = unknown); params from draw_augment_params
    (None with only_crop). Runs on img's device. H, W must be at least
    out_hw.

    Returns (img [N, oh, ow, 3], labels list of [N, oh, ow]): jitter,
    rotate, crop and flip, or with only_crop the centre crop alone."""
    n, h, w = img.shape[:3]
    oh, ow = out_hw
    if h < oh or w < ow:
        raise ValueError(f"image {h}x{w} is smaller than the output "
                         f"{oh}x{ow}: rescale it first")
    if only_crop:
        i, j = (h - oh) // 2, (w - ow) // 2
        return (img[:, i:i + oh, j:j + ow],
                [lab[:, i:i + oh, j:j + ow] for lab in labels])
    p = {k: v.to(img.device) for k, v in params.items()}
    img = color_jitter(img, p["order"], p["factors"])
    img = _rotate(img, p["angle"], order=1)
    labels = [_rotate(lab, p["angle"], order=0) for lab in labels]
    img = _crop(img, p["i"], p["j"], out_hw)
    labels = [_crop(lab, p["i"], p["j"], out_hw) for lab in labels]
    img = torch.where(_per_image(p["flip"], img), img.flip(2), img)
    labels = [torch.where(_per_image(p["flip"], lab), lab.flip(2), lab)
              for lab in labels]
    return img, labels


def host_augment(seed: int, img, labels: list, out_hw, only_crop: bool,
                 params_fn=None):
    """One image's augmentation on the host, as the datasets run it
    (counterpart of the JAX package's data/scannet.py `_host_augment`):
    img [H, W, 3] and labels [H, W] (shifted +1) as numpy, returned as
    numpy. The parameters come from draw_augment_params on a CPU
    torch.Generator seeded with `seed` (the JAX package keys its draw with
    the same int), or from params_fn(seed, (H, W), out_hw) when given (e.g.
    to replay the JAX package's draws); only_crop takes the centre crop and
    draws nothing."""
    img_t = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None]
    labels_t = [torch.from_numpy(np.ascontiguousarray(lab, np.float32))[None]
                for lab in labels]
    params = None
    if not only_crop:
        hw = tuple(img.shape[:2])
        params = (params_fn(seed, hw, out_hw) if params_fn is not None else
                  draw_augment_params(torch.Generator().manual_seed(seed), 1,
                                      hw, out_hw, device="cpu"))
    out, out_labels = augment(img_t, labels_t, params, out_hw, only_crop)
    return out[0].numpy(), [lab[0].numpy() for lab in out_labels]


def rescale_to_canonical(img: np.ndarray, labels: list, out_hw=(240, 320)):
    """The datasets' host-side rescale (the JAX package's
    data/augmentation.py rescale_to_canonical, ref helper.py:158-187):
    when h ≥ 2·oh, h < oh or w < ow, scale by max(oh/h, ow/w)·1.2 (Python
    floats), floor the new size and raise it to at least (oh, ow); the
    image [H, W, 3] f32 resized linearly, the labels [H, W] nearest (as
    f32). Otherwise both pass through. Returns (img, labels)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if not (h >= 2 * oh or h < oh or w < ow):
        return img, labels
    scale = max(oh / h, ow / w) * 1.2
    # floored as torch's interpolate(scale_factor=..) floors (the
    # reference): 968 · (240/968) · 1.2 is 288.0 in doubles
    nh, nw = max(int(h * scale), oh), max(int(w * scale), ow)
    img = resize_linear(img, (nh, nw))
    labels = [resize_nearest(np.asarray(lab, np.float32), (nh, nw))
              for lab in labels]
    return img, labels
