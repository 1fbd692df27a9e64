"""Shared building blocks: Linear-style layers, the conv, and the size formula.

Counterpart of mst_tpu/models/layers.py. Parameters use the reference's torch
layouts and names (style/model.py): ``weight`` (out, in) and ``bias`` for the
linears, ``weight`` (out, in, k) for the conv — so a state_dict maps onto the
flax tree by the rules of mst_tpu/runtime/ref_checkpoint.py:12-24. Layers are
created with explicit input widths and zero-initialized. Trained weights come
from a state_dict (benchmark.reference.mstref.weights); a fresh model for training comes from
``reset_parameters(generator)``, which draws the JAX package's torch-default
init, U(+-1/sqrt(fan_in)) for weight and bias (mst_tpu/models/layers.py:
26-122).

The products run through benchmark.reference.mstref.ops.precision (the compute dtype), and
``leaky_relu`` is where the storage dtype takes hold.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.mstref.ops import precision
from benchmark.reference.mstref.ops.init import uniform_

_SLOPE = 0.01


def mean_size(*values, factor: float = 1.0) -> int:
    """Parity: style/model.py:31-33."""
    return math.ceil(float(np.mean(values)) * factor)


def _reset_uniform(module: nn.Module, fan_in: int,
                   generator: torch.Generator) -> None:
    """weight then bias, each U(+-1/sqrt(fan_in)) (torch's default init)."""
    bound = 1.0 / math.sqrt(fan_in)
    uniform_(module.weight, bound, generator)
    uniform_(module.bias, bound, generator)


class Dense(nn.Module):
    """``x @ weight.T + bias`` (nn.Linear's layout)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_uniform(self, self.weight.shape[1], generator)

    def forward(self, x):
        return precision.matmul(x, self.weight.t()) + self.bias


class ConcatDense(nn.Module):
    """Dense over an implicit concat of broadcast-aligned parts:
    ``sum_i broadcast(part_i @ weight_cols_i.T) + bias``, summed in part
    order and then the bias, as mst_tpu's ConcatDense does. The broadcast
    concat itself is never built, so a part without the channel axis runs
    its matmul at pre-broadcast size."""

    def __init__(self, part_features: Sequence[int], features: int):
        super().__init__()
        self.part_features = tuple(part_features)
        self.weight = nn.Parameter(torch.zeros(features,
                                               sum(self.part_features)))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # fan_in = the width of the implicit concat
        _reset_uniform(self, sum(self.part_features), generator)

    def forward(self, parts):
        total = None
        offset = 0
        for part, d in zip(parts, self.part_features):
            y = precision.matmul(part, self.weight[:, offset:offset + d].t())
            offset += d
            total = y if total is None else total + y
        return total + self.bias


class DenseParams(nn.Module):
    """Owns a Dense's weight/bias for a caller that applies them itself
    (the pitched applier's note-grid tail)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_uniform(self, self.weight.shape[1], generator)

    def forward(self):
        return self.weight, self.bias


class Conv1d(nn.Module):
    """1-D convolution over the trailing axis of (N, C_in, W) inputs (parity
    target: the note->octave pooling conv, style/model.py:46-53)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.zeros(features, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # fan_in = in_channels * kernel_size
        _reset_uniform(self, self.weight.shape[1] * self.weight.shape[2],
                       generator)

    def forward(self, x):
        out = precision.conv1d(x, self.weight, stride=self.stride,
                               padding=self.padding)
        return out + self.bias[None, :, None]


def leaky_relu(x):
    """torch F.leaky_relu default slope 0.01 (used everywhere in model.py).

    Every grid-scale activation of the model passes through here, so this
    is the storage dtype's chokepoint (mst_tpu/models/layers.py:132-139):
    an fp32 input's output is stored at the storage dtype. A bf16 input
    (the sum of two stored activations) stays bf16 and is computed as JAX
    computes it: ``x >= 0 ? x : bf16(bf16(0.01) * x)``."""
    if x.dtype == precision.BF16:
        return torch.where(x >= 0, x, x * precision.bf16_value(_SLOPE))
    return precision.cast_storage(F.leaky_relu(x, _SLOPE))
