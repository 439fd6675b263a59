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


ACTIVATIONS = {"swish": swish, "tanh": tanh, "elu": elu}
