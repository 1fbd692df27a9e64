"""The pitched applier's note-grid tail as plain torch operations.

    out = sigmoid(sum_k LR(LR(xo)[o,k] + LR(xd)[d,k]) * w[k,f] + rest) * scale

A frozen copy of the port's plain version (``grid_tail_plain``), with no
kernel behind it: autograd differentiates it where gradients are wanted.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.mstref.ops.precision import BF16, bf16_value

_SLOPE = 0.01
_SLOPE_BF16 = bf16_value(_SLOPE)


def _leaky(x):
    """LR at x's dtype: a bf16 x gives ``bf16(bf16(0.01) * x)`` below 0."""
    if x.dtype == BF16:
        return torch.where(x > 0, x, x * _SLOPE_BF16)
    return F.leaky_relu(x, _SLOPE)


def grid_tail(xo, xd, w, rest, scale: Sequence[float]):
    """``xo``: (*L, O, K), ``xd``: (*L, D, K), ``w``: (K, F), ``rest``:
    broadcastable to (*L, O*D, F), ``scale``: F floats. Returns
    (*L, O*D, F) at xo's dtype. Each output sums its K terms in ascending
    k; only (*L, O, D, F) sums are held, the grid formed one k-slice at a
    time."""
    *lead, O, K = xo.shape
    D = xd.shape[-2]
    n_feat = w.shape[-1]
    a_o = _leaky(xo)
    a_d = _leaky(xd)
    y = torch.zeros(*lead, O, D, n_feat, dtype=w.dtype, device=xo.device)
    for k in range(K):
        g = _leaky(a_o[..., :, None, k] + a_d[..., None, :, k])
        y = y + g.to(w.dtype)[..., None] * w[k]
    y = y.reshape(*lead, O * D, n_feat)
    sc = torch.tensor(list(scale), dtype=y.dtype, device=y.device)
    return (torch.sigmoid(y + rest) * sc).to(xo.dtype)
