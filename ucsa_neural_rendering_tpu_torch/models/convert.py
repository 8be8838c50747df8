"""Parameters of the JAX package's SemanticNeRF ↔ this package's
SemanticNeRF state dict, so that both compute the same function (and a
test can hand the port's trained state, or its Adam moments, back).

The JAX tree (numpy leaves):
  encoder/table                         [T, F]
  {sigma,color,semantics}_net/Dense_i/kernel   [in, out]
becomes
  encoder.table                         [T, F]
  {sigma,color,semantics}_net.layers.i.weight  [out, in]  (transposed)
"""

from collections import OrderedDict

import numpy as np
import torch

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
