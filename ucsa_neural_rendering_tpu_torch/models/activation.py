"""Truncated-gradient exponential density activation (counterpart of
ucsa_neural_rendering_tpu/models/activation.py): forward exp(x) in f32
whatever the input dtype, backward g·exp(clamp(x, -15, 15)) so that one
exploding density sample cannot blow up the gradient."""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    # the f32 cast sits outside the Function, as in the JAX package, so the
    # cotangent reaches a bf16 input as bf16
    return _TruncExp.apply(x.float())
