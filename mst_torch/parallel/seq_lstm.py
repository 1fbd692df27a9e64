"""Sequence-parallel LSTM: the recurrence over a bar axis sharded across
the ranks of the mesh's ``seq`` axis, with the carry handed from rank to
rank.

Counterpart of mst_tpu/parallel/seq_lstm.py. Each rank holds T/n bars of
the projected gates (the input projection is parallel); the serial carry
chain runs as a static schedule of stages, the same on every rank:

- **relay** (few rows): rank s scans all rows of its chunk at stage s and
  hands its final (h, c) to rank s+1; n stages.
- **row-microbatched pipeline** (``B >= n * MIN_ROWS_PER_MICROBATCH``):
  the rows split into n microbatches (padded to a multiple of n); rank s
  scans microbatch m at stage s+m, so after n-1 stages every rank scans
  at once; 2n-1 stages.

Both are one ``torch.autograd.Function`` whose backward runs the stages in
reverse with the same collectives on every rank: an idle rank's hand-off
lies on no path to the loss, so autograd alone would never run its
backward collective and the other ranks would wait for it forever. Each
hand-off is one ``all_reduce`` in which every rank writes its carry into
the next rank's slot of a zero buffer, as int32 bits so that the sum
reproduces the carry's bits (including -0.0). An ``all_reduce`` runs on
CUDA tensors under gloo as under NCCL, so ranks that share one card can
run it; gloo has no ``send``/``recv`` for them.

Exactness: the local step is ``mst_torch.ops.lstm._lstm_step``, the dense
``_recur``'s, and the backward takes each step's gradient with autograd on
that step alone, so outputs and gradients carry the dense scan's bits
wherever a matmul gives the same bits for B/n rows as for B. The w_hh
gradient adds the steps' terms in the dense scan's order (last step
first), each over all rows in one product: the running sum is handed
from rank s+1 to rank s and the total broadcast from rank 0. The backward
reads no context: the compute and storage dtypes and the group ride in
``ctx`` (the CUDA engine runs the backward on its own thread).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mst_torch.ops import precision
from mst_torch.ops.lstm import _lstm_step, _recur
from mst_torch.ops.seq_context import sum_bits as _hand_off

# the row-microbatched pipeline engages when every microbatch keeps at least
# this many rows; below it the per-step fixed cost dominates and the
# (2n-1)-stage pipeline would take longer than the n-stage relay
MIN_ROWS_PER_MICROBATCH = 2


class _SeqScan(torch.autograd.Function):
    """The staged recurrence on this rank's chunk. ``gates``: (Bp, T_l,
    4H), rows padded to a multiple of ``n_mb``; ``pos``: this rank's place
    in the carry's path (0 starts from the zero carry); ``b_real``: the
    rows before the padding. Returns the outputs (Bp, T_l, H) and the
    (n, n + n_mb - 1) rows each rank scanned at each stage."""

    @staticmethod
    def forward(ctx, gates, w_hh_t, group, n, pos, n_mb, b_real, policy):
        bp, t_l, four_h = gates.shape
        h_dim = four_h // 4
        b_mb = bp // n_mb
        n_stages = n + n_mb - 1
        gx = gates.detach()[None]
        outs = gates.new_empty(bp, t_l, h_dim)
        cs = gates.new_empty(bp, t_l, h_dim)
        h0 = gates.new_zeros(1, bp, h_dim)
        c0 = gates.new_zeros(1, bp, h_dim)
        activity = torch.zeros(n, n_stages, dtype=torch.int32,
                               device=gates.device)
        with torch.no_grad(), precision.precision(*policy):
            w = precision.cast_operand(w_hh_t.detach()[None])
            recv = None
            for stage in range(n_stages):
                m = stage - pos
                send = gates.new_zeros(n, 2, 1, b_mb, h_dim)
                if 0 <= m < n_mb:
                    rows = slice(m * b_mb, (m + 1) * b_mb)
                    if pos > 0:
                        h0[:, rows], c0[:, rows] = recv[pos, 0], recv[pos, 1]
                    h, c = h0[:, rows], c0[:, rows]
                    for step in range(t_l):
                        h, c = _lstm_step(gx[:, rows, step], h, c, w)
                        outs[rows, step] = h[0]
                        cs[rows, step] = c[0]
                    if pos + 1 < n:
                        send[pos + 1, 0], send[pos + 1, 1] = h, c
                    activity[pos, stage] = b_mb
                if stage + 1 < n_stages:
                    recv = _hand_off(send, group)
        dist.all_reduce(activity, group=group)
        ctx.save_for_backward(gates, w_hh_t, h0, c0, outs, cs)
        ctx.schedule = (group, n, pos, n_mb, b_real, policy)
        ctx.mark_non_differentiable(activity)
        return outs, activity

    @staticmethod
    def backward(ctx, g_out, _):
        gates, w_hh_t, h0, c0, outs, cs = ctx.saved_tensors
        group, n, pos, n_mb, b_real, policy = ctx.schedule
        bp, t_l, four_h = gates.shape
        h_dim = four_h // 4
        b_mb = bp // n_mb
        n_stages = n + n_mb - 1
        gx = gates.detach()[None]
        g_out = g_out[None]
        d_gates = torch.zeros_like(gx)

        def prev(step, rows):
            if step == 0:
                return h0[:, rows], c0[:, rows]
            return outs[None, rows, step - 1], cs[None, rows, step - 1]

        with precision.precision(*policy):
            w = precision.cast_operand(w_hh_t.detach()[None])
            # the carries' cotangents, from the last stage to the first
            recv = None
            for stage in reversed(range(n_stages)):
                m = stage - pos
                send = gates.new_zeros(n, 2, 1, b_mb, h_dim)
                if 0 <= m < n_mb:
                    rows = slice(m * b_mb, (m + 1) * b_mb)
                    dh = dc = None
                    if pos + 1 < n:
                        dh, dc = recv[pos, 0], recv[pos, 1]
                    for step in reversed(range(t_l)):
                        dh = g_out[:, rows, step] + dh if dh is not None \
                            else g_out[:, rows, step]
                        # fresh leaves, contiguous as the dense scan's are
                        ins = [t.detach().contiguous().requires_grad_()
                               for t in (gx[:, rows, step],
                                         *prev(step, rows))]
                        with torch.enable_grad():
                            h, c = _lstm_step(*ins, w)
                        d_in, dh, dc = torch.autograd.grad(
                            [h] if dc is None else [h, c], ins,
                            [dh] if dc is None else [dh, dc])
                        d_gates[:, rows, step] = d_in
                    if pos > 0:
                        send[pos - 1, 0], send[pos - 1, 1] = dh, dc
                if stage > 0:
                    recv = _hand_off(send, group)

            # w_hh: each step's term over all real rows, added in the dense
            # scan's order; the running sum goes from rank pos+1 to pos
            acc = None
            for turn in reversed(range(n)):
                if turn == pos:
                    rows = slice(0, b_real)
                    w_leaf = w.detach().requires_grad_()
                    for step in reversed(range(t_l)):
                        h_prev = prev(step, rows)[0].contiguous()
                        with torch.enable_grad():
                            y = precision.matmul(h_prev, w_leaf)
                        term, = torch.autograd.grad(
                            y, w_leaf, d_gates[:, rows, step].contiguous())
                        acc = term if acc is None else acc + term
                buf = torch.zeros(w.shape, dtype=torch.float32,
                                  device=gates.device)
                if turn == pos:
                    buf.copy_(acc)
                acc = _hand_off(buf, group).to(w.dtype)
        return (d_gates[0], acc.to(w_hh_t.dtype)[0], None, None, None, None,
                None, None)


def _scan(gates_x, w_hh_t, mesh, n_mb: int, reverse: bool):
    n = mesh.shape["seq"]
    pos = n - 1 - mesh.seq_index if reverse else mesh.seq_index
    if reverse:
        gates_x = gates_x.flip(1)
    B = gates_x.shape[0]
    pad = (-B) % n_mb
    if pad:
        gates_x = torch.cat([gates_x, gates_x.new_zeros(
            (pad,) + tuple(gates_x.shape[1:]))])
    policy = (precision.compute_dtype(), precision.storage_dtype())
    out, activity = _SeqScan.apply(gates_x, w_hh_t, mesh.seq_group, n, pos,
                                   n_mb, B, policy)
    out = out[:B]
    return (out.flip(1) if reverse else out), activity


def seq_sharded_scan(gates_x, w_hh_t, mesh, reverse: bool = False):
    """The recurrence alone on this rank's chunk: ``gates_x`` (B, T/n, 4H)
    are its bars of the projected inputs (x @ W_ih + b), ``w_hh_t`` (H,
    4H) the replicated recurrent weights; returns its (B, T/n, H) outputs.
    The relay for few rows, the pipeline from ``n *
    MIN_ROWS_PER_MICROBATCH`` rows (module docstring). ``reverse`` scans
    right to left, from the last rank's last bar (the BiLSTM's backward
    half): the forward schedule over the globally flipped gates. Every
    rank of the mesh's seq axis must call it with the same shapes."""
    n = mesh.shape["seq"]
    n_mb = n if gates_x.shape[0] >= n * MIN_ROWS_PER_MICROBATCH else 1
    return _scan(gates_x, w_hh_t, mesh, n_mb, reverse)[0]


def seq_sharded_scan_pipelined(gates_x, w_hh_t, mesh,
                               with_activity: bool = False):
    """The row-microbatched pipeline at any row count (rows padded to a
    multiple of n). ``with_activity``: also return the (n, 2n-1) int32
    matrix of rows each rank scanned at each stage, the witness that after
    n-1 stages every rank scans at once."""
    out, activity = _scan(gates_x, w_hh_t, mesh, mesh.shape["seq"], False)
    return (out, activity) if with_activity else out


def seq_sharded_lstm(x, w_ih, w_hh, b, mesh, reverse: bool = False):
    """The seq-sharded LSTM on this rank's chunk ``x`` (B, T/n, D):
    the input projection of its bars, then the staged recurrence. Weights
    as mst_tpu lays them out: ``w_ih`` (D, 4H), ``w_hh`` (H, 4H), ``b``
    (4H), gate order (i, f, g, o)."""
    gates_x = precision.matmul(x, w_ih) + b
    return seq_sharded_scan(gates_x, w_hh, mesh, reverse=reverse)


def dense_reference_lstm(x, w_ih, w_hh, b):
    """The same LSTM on one rank over the whole sequence (the port's
    dense ``_recur``), for cross-checking."""
    gates_x = precision.matmul(x, w_ih) + b
    return _recur(gates_x[None], w_hh[None])[0]
