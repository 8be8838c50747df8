"""Truncated-gradient exponential density activation (counterpart of
ucsa_neural_rendering_tpu/models/activation.py). Forward only in this slice:
exp(x) in f32 whatever the input dtype; the clamped backward comes with the
training slice."""

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.float())
