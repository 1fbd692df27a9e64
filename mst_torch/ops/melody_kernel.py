"""K5: the melody encoder's note tail and channel pooling as one
hand-written CUDA kernel in two passes.

Replaces no TPU kernel: the JAX package leaves this tail to XLA
(mst_tpu/models/encoders.py). Its plain version, ``melody_tail_plain``, is
the composition ``models.encoders.MelodyEncoder`` runs everywhere K5 does
not: from the octave and scale-degree embeddings ``o`` (…, 8 M) and ``s``
(…, 7 M) it forms the 56-note embedding, ``channels_linear`` of the raster,
``linear`` of their concat, the leaky ReLUs, and ``combine`` over the
channels with the mask. At the serving shape it writes several GB of
(B, Cb, R, T, 10, 56, .) intermediates for a 55 MB result, and works on
every masked channel. K5 (``csrc/melody_tail.cu``; its header says what
bounds it and how the two passes and the channel skip address that) keeps
the note grid on chip, and skips masked channels.

``melody_tail`` is the wrapper: ``o`` (B, Cb, R, T, 1, 8 M) and ``s``
(B, Cb, R, T, 1, 7 M), one row a (b, c, r, t), since neither depends on the
beat fraction; the raster ``channels`` (B, Cb, R, T, 10, 56, 5); Wc (CH,
5), bc (CH), W (M, M + CH), b (M); the mask (B, Cb) or None (read as
fp32, as ``combine`` reads it); and ``embed_width``, the input width of
the products that formed ``o`` and ``s``. It returns the
(B, R, T, 10, 56, M) melody latent. CPU tensors take
``melody_tail_plain``; CUDA tensors run pass 1, sum its partials (and over
the seq ranks under a bar-sharding context, as ``combine`` does), run
pass 2, on the current stream, without waiting for the device, or raise.
K5 takes fp32 alone, and M = 8 (with CH = 7); it records no gradient.
``takes_kernel`` is the dispatch rule ``MelodyEncoder`` follows.

``melody_tail.launches`` counts K5's launches, two a call. A call adds to
the counts open on its thread (mst_torch.runtime.flops) the matmul FLOPs
the composition spends beyond the products that formed ``o`` and ``s``
once a row: those products over the other 9 beat fractions, and on the
card the two note-grid products of every channel, masked ones included.
The count is the model's on every route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mst_torch.ops import cuda_build, precision, seq_context
from mst_torch.ops.flop_scope import add_bmm_flops
from mst_torch.ops.precision import FP32
from mst_torch.ops.shapes import cat_with_broadcast, combine, squash_dims

N_OCTAVES = 8
N_SCALE_DEGREES = 7
N_BEAT_FRACTIONS = 10
N_NOTES = N_OCTAVES * N_SCALE_DEGREES
N_FEATURES = 5
WIDTHS = ((8, 7),)        # (M, CH) that csrc/melody_tail.cu instantiates


def melody_tail_plain(o, s, channels, wc, bc, w, b, mask=None):
    """The plain version: the melody encoder's composition after its
    octave and scale-degree products. ``o`` and ``s`` carry a fraction
    axis of 1 or 10 (the latter repeats each row, as the encoder's
    composition forms them). Records gradients; under the bf16 storage
    policy it rounds where the encoder's ``leaky_relu`` does."""
    # imported here: mst_torch.models imports this module
    from mst_torch.models.layers import leaky_relu
    m = w.shape[0]
    x1 = o.reshape(tuple(o.shape[:-1]) + (N_OCTAVES, m))[..., :, None, :]
    x2 = s.reshape(tuple(s.shape[:-1]) + (N_SCALE_DEGREES, m))[
        ..., None, :, :]
    x1 = squash_dims(leaky_relu(x1 + x2), -3, -1)   # (…, F, 56, m)
    x2 = leaky_relu(precision.matmul(channels, wc.t()) + bc)
    x = leaky_relu(precision.matmul(cat_with_broadcast([x1, x2], -1), w.t())
                   + b)
    return combine(x, axis=1, mask=mask, over_bars=True)


def note_grid_flops(rows: int, m: int, ch: int) -> int:
    """The matmul FLOPs of the plain version's ``channels_linear`` and
    ``linear`` over the note rows of ``rows`` (b, c, r, t) rows."""
    return 2 * rows * N_BEAT_FRACTIONS * N_NOTES * (N_FEATURES * ch
                                                    + (m + ch) * m)


def repeat_flops(rows: int, m: int, embed_width: int) -> int:
    """The matmul FLOPs of the composition's octave and scale-degree
    products over the 9 beat fractions that repeat the first one, for
    ``rows`` (b, c, r, t) rows of input width ``embed_width``."""
    return (2 * rows * (N_BEAT_FRACTIONS - 1) * embed_width
            * (N_OCTAVES + N_SCALE_DEGREES) * m)


def _is_card(x) -> bool:
    return x.is_cuda


def takes_kernel(channels, *tensors) -> bool:
    """K5 serves the call: a CUDA raster, fp32 storage and compute, and no
    gradient needed of ``channels`` or ``tensors`` (serving, under
    ``torch.inference_mode``). Training, the bf16 policies and the CPU take
    ``melody_tail_plain``. A width K5 does not take raises in the
    wrapper."""
    if not _is_card(channels) or channels.dtype != FP32:
        return False
    if precision.compute_dtype() != FP32 or precision.storage_dtype() != FP32:
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (channels,) + tensors))


@functools.cache
def _entries():
    """(pass 1, pass 2, tile rows) of csrc/melody_tail.cu, bound once."""
    lib = cuda_build.load("melody_tail")
    norms, pool = lib.mst_melody_tail_norms, lib.mst_melody_tail_pool
    norms.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    pool.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    norms.restype = pool.restype = ctypes.c_int
    return norms, pool, lib.mst_melody_tail_tile_rows()


def _check(o, s, channels, wc, bc, w, b, mask):
    """(B, Cb, R, T, M, CH) after checking the shapes and dtypes."""
    if channels.dim() != 7 or tuple(channels.shape[4:]) != (
            N_BEAT_FRACTIONS, N_NOTES, N_FEATURES):
        raise ValueError(f"melody_tail: channels {tuple(channels.shape)} "
                         f"must be (B, Cb, R, T, 10, 56, 5)")
    lead = tuple(channels.shape[:4])
    m, ch = w.shape[0], wc.shape[0]
    if (tuple(o.shape) != lead + (1, N_OCTAVES * m)
            or tuple(s.shape) != lead + (1, N_SCALE_DEGREES * m)):
        raise ValueError(f"melody_tail: o {tuple(o.shape)} and s "
                         f"{tuple(s.shape)} must be {lead + (1,)} x "
                         f"({N_OCTAVES * m},) and ({N_SCALE_DEGREES * m},)")
    if (tuple(wc.shape) != (ch, N_FEATURES) or tuple(bc.shape) != (ch,)
            or tuple(w.shape) != (m, m + ch) or tuple(b.shape) != (m,)):
        raise ValueError(f"melody_tail: weights wc {tuple(wc.shape)}, bc "
                         f"{tuple(bc.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)} must be (CH, 5), (CH,), (M, "
                         f"M + CH), (M,)")
    if mask is not None and tuple(mask.shape) != lead[:2]:
        raise ValueError(f"melody_tail: mask {tuple(mask.shape)} must be "
                         f"{lead[:2]}")
    for x in (o, s, channels, wc, bc, w, b):
        if x.dtype != FP32:
            raise ValueError(f"melody_tail: a {x.dtype} input; the kernel "
                             f"takes float32")
    for x in (o, s, wc, bc, w, b) + (() if mask is None else (mask,)):
        if x.device != channels.device:
            raise ValueError(f"melody_tail: inputs on {x.device} and "
                             f"{channels.device}")
    return lead + (m, ch)


def _flat(x):
    """``x`` contiguous and on a 16-byte boundary (the kernel's loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(o, s, channels, wc, bc, w, b, mask):
    """K5's two passes on the current stream: the (B, R, T, 10, 56, M)
    melody latent of inputs ``_check`` passed."""
    B, Cb, R, T = channels.shape[:4]
    m, ch = w.shape[0], wc.shape[0]
    if (m, ch) not in WIDTHS:
        raise ValueError(f"melody_tail: (M, CH) = {(m, ch)}; K5 takes "
                         f"{WIDTHS}")
    if Cb < 1 or B > 65535 or Cb > 65535:
        raise ValueError(f"melody_tail: {B} songs of {Cb} channels; K5 "
                         f"takes 1 to 65,535 of each")
    dev = channels.device
    out = torch.empty(B, R, T, N_BEAT_FRACTIONS, N_NOTES, m, dtype=FP32,
                      device=dev)
    if out.numel() == 0:
        return out
    norms, pool, tile_rows = _entries()
    raster, o, s = _flat(channels), _flat(o), _flat(s)
    weights = [x.contiguous() for x in (wc, bc, w, b)]
    ptrs = [x.data_ptr() for x in weights]
    # held until the launches are queued: a freed input's memory could
    # hold ``partials``
    mask = None if mask is None else _flat(mask.to(FP32))
    mask_ptr = None if mask is None else mask.data_ptr()
    rt = R * T
    partials = torch.empty(B, Cb, -(-rt // tile_rows), dtype=FP32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):            # the thread's current card
        rc = norms(raster.data_ptr(), o.data_ptr(), s.data_ptr(), mask_ptr,
                   *ptrs, partials.data_ptr(), B, Cb, rt, m, ch, stream)
        if rc == 0:
            sq = seq_context.seq_sum(partials.sum(dim=-1))
            rc = pool(raster.data_ptr(), o.data_ptr(), s.data_ptr(),
                      mask_ptr, sq.data_ptr(), *ptrs, out.data_ptr(), B, Cb,
                      rt, m, ch, stream)
    if rc != 0:
        raise RuntimeError(f"melody tail kernel launch failed: CUDA error "
                           f"{rc} ({B} songs, {Cb} channels, {rt} rows)")
    melody_tail.launches += 2
    return out


def melody_tail(o, s, channels, wc, bc, w, b, mask=None, *, embed_width):
    """The K5 wrapper (the module docstring): the (B, R, T, 10, 56, M)
    melody latent. CPU tensors run ``melody_tail_plain``; CUDA tensors run
    K5's two passes on the current stream, without waiting for the
    device. Either route counts the FLOPs the composition would."""
    B, Cb, R, T, m, ch = _check(o, s, channels, wc, bc, w, b, mask)
    rows = B * Cb * R * T
    if _is_card(channels):
        out = _launch(o, s, channels, wc, bc, w, b, mask)
        add_bmm_flops(note_grid_flops(rows, m, ch))
    elif channels.device.type == "cpu":
        out = melody_tail_plain(o, s, channels, wc, bc, w, b, mask)
    else:
        raise ValueError(f"melody_tail: unsupported device {channels.device}")
    add_bmm_flops(repeat_flops(rows, m, embed_width))
    return out


melody_tail.launches = 0
