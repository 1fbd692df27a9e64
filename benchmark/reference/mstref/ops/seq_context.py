"""Sequence-parallel context: the bar axis sharded over the mesh's ``seq``
ranks, and the ops that cross it.

Counterpart of mst_tpu/ops/seq_context.py. Usage (train-model-torch.py
--seq-parallel, ``benchmark.reference.mstref.runtime.train``'s step):

    with sequence_sharding(mesh):
        losses = loss_fn(model, batch, ...)   # each rank holds R/n bars

In JAX the context only reroutes the LSTM recurrences; GSPMD shards every
other op over the bar axis by itself. Here each rank is a process holding
bars ``[s*R/n, (s+1)*R/n)`` of every raster and activation, and each op
whose result depends on other ranks' bars has a collective of its own.
They read the context and are the identity without it:

- ``seq_sum``: a sum over the bar axis (the norms of ``ops.shapes.combine``
  over a bar axis); forward and backward all-reduce;
- ``last_step``: the final valid step ``out[:, len-1]`` (``masked_last``)
  or ``out[:, -1]``, which one rank owns; the owner writes its row and the
  others zeros, summed as int32 bits so that the owner's bits arrive
  (-0.0 included); the backward sums the cotangent and routes it to the
  owner's row;
- ``masked_flip_bars``: ``masked_flip`` over the whole bar axis (a row's
  valid prefix spans ranks): gather the bars as bits, flip, keep this
  rank's chunk; the flip is its own inverse, so the backward does the same
  to the cotangent;
- ``count_once``: the identity, whose backward keeps the cotangent on seq
  rank 0 and zeroes it elsewhere, for values every seq rank computes alike
  (the song-info losses), so that a gradient summed over the mesh counts
  them once.

The rule for all of them, and for ``parallel.seq_lstm``: the forward reads
the context and the backward reads none. The CUDA autograd engine runs the
backward on its own thread, which does not see it; the group and the
rank's place ride in ``ctx``.

The bar-axis LSTMs (``ops.lstm``'s ``bar_axis=True``) dispatch onto
``parallel.seq_lstm.seq_sharded_scan`` under the context. JAX's
``MIN_SEQ_LEN`` gate and dense fallback have no counterpart: no rank holds
the whole sequence, so the dispatch goes by the module's role, and a bar
bucket that the seq ranks do not divide is refused when the batch is built.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from benchmark.reference.mstref.ops import shapes

_MESH = contextvars.ContextVar("mstref_seq_mesh", default=None)


def current_seq_mesh():
    """The mesh whose ``seq`` axis shards the bars, or None."""
    return _MESH.get()


@contextlib.contextmanager
def sequence_sharding(mesh, axis: str = "seq"):
    """Run the bar-axis ops sharded over ``mesh``'s seq ranks within the
    scope; a no-op when ``mesh`` is None or its seq axis has one rank."""
    if axis != "seq":
        raise ValueError(f"sequence_sharding: the mesh's bar axis is "
                         f"'seq', not {axis!r}")
    if mesh is None or mesh.shape["seq"] <= 1:
        yield
        return
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def sum_bits(buf, group):
    """Sum a float32 buffer over the group as int32 bits: where one rank
    writes a value and the others zeros, every rank reads its bits."""
    dist.all_reduce(buf.view(torch.int32), group=group)
    return buf


def _place(mesh):
    return mesh.seq_group, mesh.shape["seq"], mesh.seq_index


class _SeqSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        ct = ct.clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


def seq_sum(x):
    """``x`` summed over the seq ranks (each holds its bars' partial sum);
    the backward sums the cotangent, since every rank's use of the total
    adds to it."""
    mesh = current_seq_mesh()
    return x if mesh is None else _SeqSum.apply(x, mesh.seq_group)


class _LastRead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out, step, group, first):
        t_l = out.shape[1]
        local = step - first
        owned = (local >= 0) & (local < t_l)
        idx = local.clamp(0, t_l - 1).reshape(
            -1, *([1] * (out.dim() - 1))).expand(-1, 1, *out.shape[2:])
        picked = torch.gather(out, 1, idx).squeeze(1).float()
        owned = owned.reshape(-1, *([1] * (picked.dim() - 1)))
        buf = torch.where(owned, picked, torch.zeros_like(picked))
        ctx.save_for_backward(idx, owned)
        ctx.group, ctx.shape, ctx.dtype = group, out.shape, out.dtype
        return sum_bits(buf, group).to(out.dtype)

    @staticmethod
    def backward(ctx, ct):
        idx, owned = ctx.saved_tensors
        ct = ct.float().clone()
        dist.all_reduce(ct, group=ctx.group)
        ct = torch.where(owned, ct, torch.zeros_like(ct)).to(ctx.dtype)
        d_out = ct.new_zeros(ctx.shape).scatter(1, idx, ct[:, None])
        return d_out, None, None, None


def last_step(out, lengths=None):
    """The final valid step of each row of ``out`` (B, T, ...): ``out[:,
    lengths-1]`` (``masked_last``) or, without ``lengths``, ``out[:, -1]``.
    Under the context ``out`` holds this rank's T/n steps and ``lengths``
    counts global steps; the result is the same on every seq rank."""
    mesh = current_seq_mesh()
    if mesh is None:
        return out[:, -1] if lengths is None else shapes.masked_last(
            out, lengths)
    group, n, s = _place(mesh)
    t_l = out.shape[1]
    if lengths is None:
        step = torch.full((out.shape[0],), n * t_l - 1, dtype=torch.long,
                          device=out.device)
    else:
        step = (lengths.to(out.device).long() - 1).clamp(min=0)
    return _LastRead.apply(out, step, group, s * t_l)


def _gather_bars(x, group, n, s):
    """(B, T/n, ...) on each rank -> the whole (B, T, ...), bit for bit."""
    buf = torch.zeros((n,) + tuple(x.shape), dtype=torch.float32,
                      device=x.device)
    buf[s] = x
    sum_bits(buf, group)
    whole = buf.to(x.dtype).movedim(0, 1)
    return whole.reshape(x.shape[0], n * x.shape[1], *x.shape[2:])


def _flip_chunk(x, lengths, group, n, s):
    t_l = x.shape[1]
    whole = shapes.masked_flip(_gather_bars(x, group, n, s), lengths)
    return whole[:, s * t_l:(s + 1) * t_l].contiguous()


class _FlipBars(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, lengths, group, n, s):
        ctx.save_for_backward(lengths)
        ctx.place = (group, n, s)
        return _flip_chunk(x, lengths, group, n, s)

    @staticmethod
    def backward(ctx, ct):
        lengths, = ctx.saved_tensors
        return _flip_chunk(ct, lengths, *ctx.place), None, None, None, None


def masked_flip_bars(x, lengths):
    """``masked_flip(x, lengths)`` of the whole bar axis; under the context
    ``x`` (B, T/n, ...) is this rank's chunk and the result its chunk of
    the flipped whole."""
    mesh = current_seq_mesh()
    if mesh is None:
        return shapes.masked_flip(x, lengths)
    return _FlipBars.apply(x, lengths.to(x.device), *_place(mesh))


class _CountOnce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return (ct if ctx.keep else torch.zeros_like(ct)), None


def count_once(*xs):
    """``xs`` as they are; under the context their cotangents stay on seq
    rank 0 alone (module docstring)."""
    mesh = current_seq_mesh()
    if mesh is None:
        return xs
    return tuple(_CountOnce.apply(x, mesh.seq_index == 0) for x in xs)
