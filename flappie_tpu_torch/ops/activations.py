"""Elementwise activations (reference: src/layers.c:24-123, util.h).

Counterpart of flappie_tpu/ops/activations.py.  The reference computes
tanh via the logistic (``2*logistic(2x) - 1``); the native op is the
same function.
"""

import torch


def swish(x):
    return x * torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def elu(x):
    return torch.where(x >= 0, x, torch.expm1(x))


def softplus(x):
    """jax.nn.softplus's formula, log(1 + e^x) = max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


ACTIVATIONS = {"swish": swish, "tanh": tanh, "elu": elu}
