"""K6: the served request's packing and compaction as one hand-written
CUDA kernel in two passes.

Replaces no TPU kernel: the JAX package leaves both steps to XLA
(mst_tpu/transfer.py, ``_pack_word`` and ``_compact_song``). Its plain
version is the composition ``mst_torch.transfer`` runs everywhere K6 does
not, ``_compact_song(_pack_word(x, tpb), ...)``: about fifteen full-size
elementwise passes over the applier's output, then a block prefix product
and a rank lookup over every cell of the (B, Cb, Rb, ...) grid. K6
(``csrc/pack_compact.cu``; its header says what bounds it and how the two
passes address that) reads the valid cells once to count each 128-cell
block's notes, then revisits only the routed blocks to write their records.

``pack_compact`` is the wrapper: the applier's output ``x`` (B, C, R, T,
10, N, F), F = 5 and N = 56 pitched or F = 2 and N = 47 unpitched; the
ticks per beat ``tpb`` (B,); the channels ``n_channels`` and bars
``n_bars`` (B,) of each job; the record ``capacity`` and the routing
table's ``max_blocks``. It returns ``(count, n_live_blocks, records)``
with the values and dtypes of ``_compact_song(_pack_word(x, tpb), ...)``
bit for bit: the routing-table overflow (``count`` sums only the first
``max_blocks`` live blocks) and the (0, 0) records past the count
included. Between the passes a few (B, G)-sized torch ops
(``route_blocks``) work out the routed blocks and where their records
start. It runs K6's passes on the current stream, without waiting for the
device, or raises: K6 takes CUDA tensors and an fp32 ``x`` alone.
``takes_kernel`` is the dispatch rule of ``transfer._fused_transfer_apply``.

``pack_compact.launches`` counts K6's launches, two a call. A call adds to
the counts open on its thread (mst_torch.runtime.flops) the block prefix
product that the composition spends, so the request counts the same on
every route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mst_torch.ops import cuda_build
from mst_torch.ops.flop_scope import add_bmm_flops
from mst_torch.ops.precision import FP32

BLOCK = 128                  # compaction block: transfer._BLOCK's cells
N_BEAT_FRACTIONS = 10
FAMILIES = ((56, 5), (47, 2))    # (N, F): pitched, unpitched
SPAN = "compact_kernel.pack_compact"


def _is_card(x) -> bool:
    return x.is_cuda


def takes_kernel(x) -> bool:
    """K6 serves every applier output on a card (the serving programs, on
    one card and on each shard of a mesh); one it does not take raises in
    the wrapper. The CPU takes the composition, and so does the ladder's
    dense compaction, which ``transfer._fused_transfer_apply`` decides
    before asking."""
    return _is_card(x)


def route_blocks(counts, max_blocks: int):
    """Between the passes, on the device: from the blocks' note counts
    (B, G) int32, ``(routed, incl, count, n_live)``: the counts of the
    routed blocks (the first ``max_blocks`` live ones) and 0 elsewhere,
    (B, G) int32; their inclusive prefix, (B, G) int64, so a routed block's
    records start at ``incl - routed``; the notes of the routed blocks and
    the live blocks, (B,) int64 each."""
    live = counts > 0
    rank = live.cumsum(-1)                    # live blocks up to each one
    routed = torch.where(live & (rank <= max_blocks), counts, 0)
    incl = routed.cumsum(-1)
    return routed, incl, incl[:, -1], rank[:, -1]


@functools.cache
def _entries():
    """(pass 1, pass 2) of csrc/pack_compact.cu, bound once."""
    lib = cuda_build.load("pack_compact")
    count, write = lib.mst_pack_compact_count, lib.mst_pack_compact_write
    count.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
        ctypes.c_void_p]
    write.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]
    count.restype = write.restype = ctypes.c_int
    return count, write


def _shape(x):
    """(jobs, features, cells a job, cells a (c, r) row, bars) of ``x``."""
    B, C, R = x.shape[:3]
    row = x[0, 0, 0, ..., 0].numel()
    return B, x.shape[-1], C * R * row, row, R


def _raise(rc, what, x):
    if rc != 0:
        raise RuntimeError(f"pack_compact kernel {what} failed: CUDA error "
                           f"{rc} (applier output {tuple(x.shape)})")


def count_blocks(x, tpb, n_channels, n_bars):
    """Pass 1 on the card: (B, G) int32 note counts. Inputs as
    ``pack_compact`` checked them."""
    B, F, M, row, R = _shape(x)
    counts = torch.empty(B, -(-M // BLOCK), dtype=torch.int32,
                         device=x.device)
    count, _ = _entries()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):      # the thread's current card
        rc = count(x.data_ptr(), tpb.data_ptr(), n_channels.data_ptr(),
                   n_bars.data_ptr(), counts.data_ptr(), B, F, M, row, R,
                   stream)
    _raise(rc, "pass 1", x)
    pack_compact.launches += 1
    return counts


def write_records(x, tpb, n_channels, n_bars, routed, incl, capacity: int):
    """Pass 2 on the card: the (B, capacity, 2) int64 records."""
    B, F, M, row, R = _shape(x)
    records = torch.zeros(B, capacity, 2, dtype=torch.int64,
                          device=x.device)
    _, write = _entries()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = write(x.data_ptr(), tpb.data_ptr(), n_channels.data_ptr(),
                   n_bars.data_ptr(), routed.data_ptr(), incl.data_ptr(),
                   records.data_ptr(), capacity, B, F, M, row, R, stream)
    _raise(rc, "pass 2", x)
    pack_compact.launches += 1
    return records


def _check(x, tpb, n_channels, n_bars, capacity, max_blocks):
    """The inputs as the passes take them: ``x`` a contiguous fp32 tensor
    on a card, ``tpb`` float32, the counts int64, all on ``x``'s device."""
    if not _is_card(x):
        raise ValueError(f"pack_compact: x on {x.device}; K6 takes CUDA "
                         f"tensors (elsewhere the transfer runs the "
                         f"composition)")
    if x.dim() != 7 or x.shape[4] != N_BEAT_FRACTIONS or \
            tuple(x.shape[5:]) not in FAMILIES:
        raise ValueError(f"pack_compact: x {tuple(x.shape)} must be (B, C, "
                         f"R, T, 10, N, F) with (N, F) in {FAMILIES}")
    if x.dtype != FP32:
        raise ValueError(f"pack_compact: a {x.dtype} applier output; K6 "
                         f"takes float32")
    B = x.shape[0]
    if x.numel() == 0 or x.numel() >= 2 ** 31 * B:
        raise ValueError(f"pack_compact: x {tuple(x.shape)}: K6 takes a "
                         f"nonempty grid of under 2**31 floats a job")
    if capacity < 1 or max_blocks < 1:
        raise ValueError(f"pack_compact: capacity {capacity} and max_blocks "
                         f"{max_blocks} must be positive")
    rows = []
    for name, t, dtype in (("tpb", tpb, FP32),
                           ("n_channels", n_channels, torch.int64),
                           ("n_bars", n_bars, torch.int64)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"pack_compact: {name} {tuple(t.shape)} must "
                             f"be ({B},)")
        if t.device != x.device:
            raise ValueError(f"pack_compact: {name} on {t.device}, x on "
                             f"{x.device}")
        rows.append(t.to(dtype).contiguous())
    return (x.contiguous(), *rows)


def pack_compact(x, tpb, n_channels, n_bars, capacity: int,
                 max_blocks: int):
    """The K6 wrapper (the module docstring): ``(count, n_live_blocks,
    records)`` of ``_compact_song(_pack_word(x, tpb), n_channels, n_bars,
    capacity, max_blocks)``, from K6's two passes on the current stream.
    It counts the FLOPs the composition would."""
    inputs = _check(x, tpb, n_channels, n_bars, capacity, max_blocks)
    with torch.profiler.record_function(SPAN):
        counts = count_blocks(*inputs)
        routed, incl, count, n_live = route_blocks(counts, max_blocks)
        out = count, n_live, write_records(*inputs, routed, incl, capacity)
    # the composition's block prefixes: one (B G, 128) @ (128, 128) product
    G = -(-x[0, ..., 0].numel() // BLOCK)
    add_bmm_flops(2 * x.shape[0] * G * BLOCK * BLOCK)
    return out


pack_compact.launches = 0
