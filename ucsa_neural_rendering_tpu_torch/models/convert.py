"""Weights carried into this package.

SemanticNeRF: the JAX package's parameters ↔ this package's state dict, so
that both compute the same function (and a test can hand the port's trained
state, or its Adam moments, back). The JAX tree (numpy leaves):
  encoder/table                         [T, F]
  {sigma,color,semantics}_net/Dense_i/kernel   [in, out]
becomes
  encoder.table                         [T, F]
  {sigma,color,semantics}_net.layers.i.weight  [out, in]  (transposed)

DeepLabV3: the JAX package's flax (params, batch_stats) → this package's
state dict (deeplab_state_from_jax, the inverse of the JAX package's
torchvision → flax converter), and a torchvision or Lightning checkpoint
file → a loaded DeepLabV3 (load_deeplab_checkpoint, the reference's
checkpoint surgery: aux head and wrapper prefixes dropped).
"""

import re
from collections import OrderedDict

import numpy as np
import torch

from ..utils.device import resolve_device
from .deeplabv3 import DeepLabV3

_NETS = ("sigma_net", "color_net", "semantics_net")


def params_from_jax(params) -> "OrderedDict[str, torch.Tensor]":
    """params: the JAX model's `params` tree of numpy (or array-like)
    leaves, with or without the outer {"params": ...} level → a state dict
    for SemanticNeRF.load_state_dict (f32 CPU tensors)."""
    if "params" in params:
        params = params["params"]
    state = OrderedDict()
    state["encoder.table"] = torch.from_numpy(
        np.array(params["encoder"]["table"], dtype=np.float32))
    for net in _NETS:
        layers = params[net]
        n = len(layers)
        for i in range(n):
            kernel = np.array(layers[f"Dense_{i}"]["kernel"], dtype=np.float32)
            state[f"{net}.layers.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.T))
    return state


def params_to_jax(state) -> dict:
    """The inverse of params_from_jax: a SemanticNeRF state dict (or any
    mapping of the same names, e.g. Adam's moments) → the JAX model's
    `params` tree of f32 numpy leaves."""
    tree = {"encoder": {"table": np.array(
        state["encoder.table"].detach().cpu(), dtype=np.float32)}}
    for name, t in state.items():
        net, *rest = name.split(".")          # <net>.layers.<i>.weight
        if net in _NETS:
            tree.setdefault(net, {})[f"Dense_{rest[1]}"] = {"kernel": np.array(
                t.detach().cpu(), dtype=np.float32).T.copy()}
    return tree


# ------------------------------------------------------------------ DeepLabV3
# flax module path (under params / batch_stats) → torchvision key prefix
_BLOCK = re.compile(r"(layer\d+)_(\d+)$")
_BLOCK_LEAF = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}


def _deeplab_paths(params) -> list[tuple[tuple[str, ...], str]]:
    """(flax module path, torch key prefix) for every conv and BN of the
    JAX DeepLabV3's tree."""
    paths = []
    backbone = params["backbone"]
    for name in ("conv1", "bn1"):
        paths.append((("backbone", name), f"backbone.{name}"))
    for block in backbone:
        m = _BLOCK.match(block)
        if m is None:
            continue
        for leaf in backbone[block]:
            paths.append((("backbone", block, leaf),
                          f"backbone.{m.group(1)}.{m.group(2)}."
                          + _BLOCK_LEAF.get(leaf, leaf)))
    for i in range(5):
        # branches 0-3: Sequential(conv, bn, relu); 4: (pool, conv, bn, relu)
        conv_sub = 1 if i == 4 else 0
        paths.append((("aspp", f"aspp_conv{i}"),
                      f"classifier.0.convs.{i}.{conv_sub}"))
        paths.append((("aspp", f"aspp_bn{i}"),
                      f"classifier.0.convs.{i}.{conv_sub + 1}"))
    paths += [(("aspp", "aspp_project"), "classifier.0.project.0"),
              (("aspp", "aspp_project_bn"), "classifier.0.project.1"),
              (("head_conv",), "classifier.1"),
              (("head_bn",), "classifier.2"),
              (("classifier",), "classifier.4")]
    return paths


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def deeplab_state_from_jax(params, batch_stats) -> \
        "OrderedDict[str, torch.Tensor]":
    """The JAX package's DeepLabV3 `params` and `batch_stats` trees (numpy
    or array-like leaves, with or without their outer {"params": ...} /
    {"batch_stats": ...} level) → a state dict for DeepLabV3.load_state_dict
    (f32 CPU tensors): conv kernels HWIO → OIHW, BN scale / bias / mean /
    var → weight / bias / running_mean / running_var, num_batches_tracked
    0."""
    if "params" in params:
        params = params["params"]
    if "batch_stats" in batch_stats:
        batch_stats = batch_stats["batch_stats"]
    state = OrderedDict()
    for path, key in _deeplab_paths(params):
        p = _node(params, path)
        if "kernel" in p:  # conv
            state[key + ".weight"] = _f32(np.transpose(p["kernel"],
                                                       (3, 2, 0, 1)))
            if "bias" in p:
                state[key + ".bias"] = _f32(p["bias"])
            continue
        s = _node(batch_stats, path)
        state[key + ".weight"] = _f32(p["scale"])
        state[key + ".bias"] = _f32(p["bias"])
        state[key + ".running_mean"] = _f32(s["mean"])
        state[key + ".running_var"] = _f32(s["var"])
        state[key + ".num_batches_tracked"] = torch.tensor(0)
    return state


def strip_lightning_prefix(sd: dict) -> dict:
    """Drop the aux head and the Lightning wrapper prefixes of a
    checkpoint's keys (the reference's train_joint.py:115-127)."""
    out = {}
    for k, v in sd.items():
        if "aux_classifier" in k:
            continue
        for prefix in ("_model._model.", "seg_model._model.", "_model.",
                       "seg_model.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def read_deeplab_checkpoint(path) -> dict:
    """A torchvision `deeplabv3_resnet101` state dict (.pth) or a Lightning
    checkpoint (.ckpt, its "state_dict") → a DeepLabV3 state dict on the
    CPU, the aux head and the wrapper prefixes dropped. The file is
    unpickled (torch.load(weights_only=False)), so read only checkpoints
    you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return strip_lightning_prefix(ckpt)


def load_deeplab_checkpoint(path, device="cuda"):
    """read_deeplab_checkpoint's state dict → a DeepLabV3 (ResNet-101, the
    checkpoint's number of classes) on `device` with those weights, loaded
    strict."""
    device = resolve_device(device)
    sd = read_deeplab_checkpoint(path)
    model = DeepLabV3(num_classes=sd["classifier.4.bias"].shape[0],
                      device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.to(device)
