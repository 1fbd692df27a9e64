"""K1: the scatter-max rasterizer as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``mst_tpu/ops/pallas_raster.py:_kernel``
(via ``_pallas_call``, :96-125). The kernel source is ``csrc/raster.cu``;
its header says what bounds it on the H100 (one write of a mostly-zero
raster) and what the design does about it: one cooperative launch that
zero-fills the raster and then applies one note per thread with an
int-bit ``atomicMax`` that is exact for every fp32 value (NaN wins,
negatives and -0.0 lose to the zero base), so any valid input is taken.

The raster comes in fp32 or, for the bf16 storage policy, in bf16
(``out_dtype``, as ``_pallas_call``'s, pallas_raster.py:85-90). The bf16
form is the bf16 cast of the fp32 raster: rounding to nearest is monotone,
so the cast commutes with the max (mst_tpu/ops/device_raster.py:128-133).
The kernel writes the bf16 raster directly, once: the same int-bit max on
the 16-bit pattern, through a 16-bit compare-and-swap.

``rasterize`` is the wrapper: a tensor on the CPU takes the plain version
``segment_rasterize_plain``; a tensor anywhere else launches the kernel or
raises. It checks dtypes and shapes only and never waits for the device.
``rasterize.launches`` counts the fp32 form's launches,
``rasterize.launches_bf16`` the bf16 form's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mst_torch.ops import cuda_build
from mst_torch.ops.precision import BF16, FP32

SENTINEL_ROW = 2 ** 30


@functools.cache
def _entry():
    """The C entry point of csrc/raster.cu (built and bound once)."""
    fn = cuda_build.load("raster").mst_raster
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_records(row, note_idx, acc, duration, velocity, valid):
    n = row.shape[0]
    for name, t, dtype in (("row", row, torch.int32),
                           ("note_idx", note_idx, torch.int32),
                           ("acc", acc, torch.int32),
                           ("duration", duration, torch.float32),
                           ("velocity", velocity, torch.float32),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name}: want ({n},) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _check_out_dtype(out_dtype):
    if out_dtype not in (FP32, BF16):
        raise ValueError(f"rasterize: out_dtype {out_dtype}; the kernel "
                         f"writes float32 or bfloat16")


def segment_rasterize_plain(row, note_idx, acc, duration, velocity, valid,
                            n_rows: int, n_notes: int, n_feat: int,
                            out_dtype=FP32):
    """Plain torch scatter-max -> (n_rows, n_notes * n_feat) on a zero
    base: the semantics of mst_tpu.ops.device_raster.segment_rasterize
    (``.at[].max``) through ``scatter_reduce_(..., "amax")``. Notes that are
    invalid, or whose row or lane lies outside the raster, are skipped.
    -0.0 becomes +0.0 before the scatter: on the CPU torch's max keeps the
    zero base against it, on CUDA its atomic would store -0.0, and JAX and
    K1 keep +0.0. NaN of either sign propagates. The max is taken in fp32
    and the raster cast once to ``out_dtype``."""
    _check_out_dtype(out_dtype)
    lanes = n_notes * n_feat
    out = torch.zeros(n_rows * lanes, dtype=torch.float32,
                      device=row.device)
    keep = valid & (row >= 0) & (row < n_rows)
    r = row[keep].long() * lanes
    lane0 = note_idx[keep].long() * n_feat
    dur, vel = (torch.where(v == 0, 0.0, v) for v in (duration[keep],
                                                       velocity[keep]))
    cols = [lane0, lane0 + 1]
    vals = [dur, vel]
    if n_feat == 5:
        cols.append(lane0 + 2 + acc[keep].long())
        vals.append(torch.ones_like(dur))
    col = torch.cat(cols)
    val = torch.cat(vals)
    inside = (col >= 0) & (col < lanes)
    idx = torch.cat([r] * len(cols))[inside] + col[inside]
    out.scatter_reduce_(0, idx, val[inside], "amax", include_self=True)
    return out.view(n_rows, lanes).to(out_dtype)


def rasterize(row, note_idx, acc, duration, velocity, valid,
              n_rows: int, n_notes: int, n_feat: int, out_dtype=FP32):
    """Scatter-max rasterization of (N,) note records -> (n_rows,
    n_notes * n_feat) at ``out_dtype`` (fp32 or bf16). CPU tensors run the
    plain version; CUDA tensors run K1, one launch that writes the whole
    raster, on the current stream and without waiting for the device."""
    _check_records(row, note_idx, acc, duration, velocity, valid)
    _check_out_dtype(out_dtype)
    if row.device.type == "cpu":
        return segment_rasterize_plain(row, note_idx, acc, duration,
                                       velocity, valid, n_rows, n_notes,
                                       n_feat, out_dtype)
    launch = _entry()
    if not row.is_cuda:
        raise ValueError(f"rasterize: unsupported device {row.device}")
    ins = [t.contiguous() for t in (row, note_idx, acc, duration, velocity,
                                    valid)]
    out = torch.empty((n_rows, n_notes * n_feat), dtype=out_dtype,
                      device=row.device)
    if out.numel() == 0:
        return out
    n = ins[0].shape[0]
    stream = torch.cuda.current_stream(row.device).cuda_stream
    bf16 = out_dtype == BF16
    # the C side launches on the thread's current card, which on the
    # trainer's prefetch thread, or on a rank's, need not be row's
    with torch.cuda.device(row.device):
        rc = launch(*(t.data_ptr() for t in ins), n, n_rows, n_notes,
                    n_feat, int(bf16), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {rc}")
    if bf16:
        rasterize.launches_bf16 += 1
    else:
        rasterize.launches += 1
    return out


rasterize.launches = 0
rasterize.launches_bf16 = 0
