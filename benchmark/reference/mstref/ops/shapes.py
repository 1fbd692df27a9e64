"""Tensor-shape ops: squash, broadcast-concat, norm-weighted channel pooling.

Counterpart of mst_tpu/ops/shapes.py (parity target: style/utils/pytorch.py
squash_dims :7, cat_with_broadcast :54, and style/model.py:796-815 combine).
All are plain torch functions; ``combine`` additionally takes a channel mask
so padded batches are exact.
"""

from __future__ import annotations

from typing import Optional, Sequence

import math

import torch

from benchmark.reference.mstref.ops import seq_context


def squash_dims(x, dim_begin: int, dim_end: Optional[int] = None):
    """Merge dims [dim_begin, dim_end) into one (parity: utils/pytorch.py:7-16)."""
    shape = tuple(x.shape)
    if dim_end is None:
        dim_end = len(shape)
    if dim_begin < 0:
        dim_begin += len(shape)
        dim_end += len(shape)
    merged = math.prod(shape[dim_begin:dim_end])
    return x.reshape(*shape[:dim_begin], merged, *shape[dim_end:])


def split_note_features(x, n_feat: int):
    """NF-fused raster (…, N*F) -> (…, N, F); 7-D input and ``None`` pass
    through. The device rasterizer emits (note, feature) fused in one minor
    axis; model entry points accept either layout through this helper."""
    if x is None or x.dim() == 7:
        return x
    nf = x.shape[-1]
    if nf % n_feat:
        raise ValueError(f"minor axis {nf} is not a multiple of {n_feat}")
    return x.reshape(*x.shape[:-1], nf // n_feat, n_feat)


def cat_with_broadcast(tensors: Sequence, axis: int = 0):
    """Broadcast all tensors to the elementwise-max shape (except ``axis``)
    then concatenate (parity: utils/pytorch.py:54-65)."""
    rank = tensors[0].dim()
    if axis < 0:
        axis += rank
    target = [max(t.shape[i] for t in tensors) for i in range(rank)]
    expanded = []
    for t in tensors:
        shape = list(target)
        shape[axis] = t.shape[axis]
        expanded.append(t.expand(shape))
    return torch.cat(expanded, dim=axis)


def combine(x, axis: int = 1, mask=None, safe: bool = True,
            over_bars: bool = False):
    """Norm-weighted mean across ``axis`` (parity: style/model.py:796-815).

    Each slice along ``axis`` is weighted by ``sqrt(1 + ||slice||^2)`` (norm
    over all non-batch, non-axis dims, accumulated in fp32) and the weighted
    sum is divided by the per-batch total of the weights. ``mask``: optional
    (batch, n_axis) 0/1 array of valid slices — masked slices contribute
    nothing, and a fully masked row yields zeros rather than 0/0.
    ``over_bars``: the norm's dims include a bar axis, which a
    sequence-sharding context spreads over ranks (the squared norms are
    then summed over them, ``seq_context.seq_sum``)."""
    norm_axes = tuple(i for i in range(x.dim()) if i not in (0, axis))
    xf = x.float()
    sq = (xf * xf).sum(dim=norm_axes, keepdim=True)
    if over_bars:
        sq = seq_context.seq_sum(sq)
    norm = torch.sqrt(1.0 + sq) if safe else torch.sqrt(sq)
    if mask is not None:
        mask_shape = [1] * x.dim()
        mask_shape[0] = mask.shape[0]
        mask_shape[axis] = mask.shape[1]
        m = mask.reshape(mask_shape).to(x.dtype)
        norm = norm * m
        x = x * m
    num = (x * norm).sum(dim=axis)
    denom = norm.sum(dim=tuple(range(1, x.dim())))  # per-batch scalar
    if mask is not None:
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return num / denom.reshape([denom.shape[0]] + [1] * (num.dim() - 1))


def combine_pair(a, b, b_mask=None):
    """combine() of two stacked tensors (parity: model.py:796-804 with
    ``combine(t1, t2)``). ``b_mask``: optional (B,) validity of ``b`` per
    batch row; masked rows return ``a`` exactly. ``a`` and ``b`` are
    (B, R, ...) with R a bar axis: under a sequence-sharding context the
    squared norms are summed over the seq ranks."""
    x = torch.stack([a, b])  # (2, B, ...)
    if b_mask is not None:
        b_m = b_mask.to(a.dtype)
        gate = torch.stack([torch.ones_like(b_m), b_m])  # (2, B)
        gate = gate.reshape(tuple(gate.shape) + (1,) * (x.dim() - 2))
        x = x * gate
    norm_axes = tuple(range(2, x.dim()))
    sq = seq_context.seq_sum((x * x).sum(dim=norm_axes, keepdim=True))
    norm = torch.sqrt(1.0 + sq)
    if b_mask is not None:
        norm = norm * gate
    num = (x * norm).sum(dim=0)
    denom = norm.sum(dim=(0,) + tuple(range(2, x.dim())))
    return num / denom.reshape([num.shape[0]] + [1] * (num.dim() - 1))


def masked_last(x, lengths):
    """x[:, length-1] per batch row: the final valid step of a padded
    sequence."""
    idx = (lengths - 1).clamp(min=0).long()
    idx = idx.reshape(-1, *([1] * (x.dim() - 1))).expand(
        -1, 1, *x.shape[2:])
    return torch.gather(x, 1, idx).squeeze(1)


def masked_flip(x, lengths):
    """Reverse each row's valid prefix in place: out[:, j] = x[:, len-1-j]
    for j < len, padding untouched (the backward direction of a BiLSTM over
    padded sequences)."""
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)
    lengths = lengths.to(x.device).long()
    src = torch.where(pos[None, :] < lengths[:, None],
                      lengths[:, None] - 1 - pos[None, :], pos[None, :])
    src = src.reshape(src.shape[0], T, *([1] * (x.dim() - 2))).expand(
        -1, -1, *x.shape[2:])
    return torch.gather(x, 1, src)
