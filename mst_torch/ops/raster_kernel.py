"""K1: the scatter-max rasterizer as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``mst_tpu/ops/pallas_raster.py:_kernel``
(via ``_pallas_call``, :96-125). The kernel source is ``csrc/raster.cu``;
its header says what bounds it on the H100 (one write of a mostly-zero
raster) and what the design does about it (one thread per note, exact
int-bit ``atomicMax`` on a zero base).

``rasterize`` is the wrapper: a tensor on the CPU takes the plain version
``segment_rasterize_plain``; a tensor anywhere else launches the kernel or
raises. ``rasterize.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mst_torch.ops import cuda_build

SENTINEL_ROW = 2 ** 30


def _entry():
    """The C entry point of csrc/raster.cu (built at first use)."""
    fn = cuda_build.load("raster").mst_raster
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
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


def segment_rasterize_plain(row, note_idx, acc, duration, velocity, valid,
                            n_rows: int, n_notes: int, n_feat: int):
    """Plain torch scatter-max -> (n_rows, n_notes * n_feat) fp32 on a zero
    base: the semantics of mst_tpu.ops.device_raster.segment_rasterize
    (``.at[].max``) through ``scatter_reduce_(..., "amax")``. Notes that are
    invalid, or whose row or lane lies outside the raster, are skipped."""
    lanes = n_notes * n_feat
    out = torch.zeros(n_rows * lanes, dtype=torch.float32,
                      device=row.device)
    keep = valid & (row >= 0) & (row < n_rows)
    r = row[keep].long() * lanes
    lane0 = note_idx[keep].long() * n_feat
    dur, vel = duration[keep], velocity[keep]
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
    return out.view(n_rows, lanes)


def rasterize(row, note_idx, acc, duration, velocity, valid,
              n_rows: int, n_notes: int, n_feat: int):
    """Scatter-max rasterization of (N,) note records -> (n_rows,
    n_notes * n_feat) fp32. CPU tensors run the plain version; CUDA tensors
    run K1, whose int-bit max needs every valid duration and velocity to be
    >= 0 (checked here: a negative or NaN value raises)."""
    _check_records(row, note_idx, acc, duration, velocity, valid)
    if row.device.type == "cpu":
        return segment_rasterize_plain(row, note_idx, acc, duration,
                                       velocity, valid, n_rows, n_notes,
                                       n_feat)
    launch = _entry()
    if not row.is_cuda:
        raise ValueError(f"rasterize: unsupported device {row.device}")
    bad = valid & ~((duration >= 0) & (velocity >= 0))
    if bool(bad.any()):
        raise ValueError("rasterize: a valid note has a negative or NaN "
                         "duration or velocity; the kernel's max needs "
                         "values >= 0")
    ins = [t.contiguous() for t in (row, note_idx, acc, duration, velocity,
                                    valid)]
    out = torch.zeros((n_rows, n_notes * n_feat), dtype=torch.float32,
                      device=row.device)
    n = ins[0].shape[0]
    if n == 0:
        return out
    stream = torch.cuda.current_stream(row.device).cuda_stream
    rc = launch(*(t.data_ptr() for t in ins), n, n_rows, n_notes, n_feat,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {rc}")
    rasterize.launches += 1
    return out


rasterize.launches = 0
