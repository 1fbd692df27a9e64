"""On-device rasterization: quantized note records -> dense piano-roll.

Counterpart of mst_tpu/ops/device_raster.py. The host parses and quantizes
MIDI (exact float64 grid math, mst_torch.ops.quantize) and ships only the
note records — (cell row, note index, accidental, duration, velocity,
valid), a few hundred KB — while the dense (channel, bar, beat, fraction,
note*feature) raster is materialized on the device by ``segment_rasterize``:
K1 (``csrc/raster.cu``, through mst_torch.ops.raster_kernel) for CUDA
tensors, its plain torch version for CPU tensors.

The host preparation (``encode_notes``, ``concat_and_pad`` with the sentinel
row 2**30 and the ``_pad_to`` note buckets) is a copy of the JAX package's,
so both frameworks see the same records. ``device_rasterize_song`` and
``device_rasterize_batch`` are the trainer's entry points: one K1 launch per
note family for a whole batch. ``device_rasterize_batch_sharded`` is the
one over ranks: each rank encodes and rasterizes only its own songs and,
with a seq axis, only its own bars of them, so the raster is born on its
rank and never crosses ranks. Each takes
``out_dtype``: float32, or bfloat16 for the bf16 storage policy, which K1
then writes directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mst_torch.ops import raster_kernel
from mst_torch.ops.precision import FP32
from mst_torch.ops.rasterize import QNotes, Rasterizer

SENTINEL_ROW = raster_kernel.SENTINEL_ROW


@dataclasses.dataclass
class DeviceNotes:
    """Host-prepared note records for device rasterization (all (N,) arrays,
    padded to a static length with ``valid``)."""

    row: np.ndarray       # int32, flattened (channel, bar, beat, frac) cell
    note_idx: np.ndarray  # int32, raster note row (0..n_notes)
    acc: np.ndarray       # int32, accidental code (pitched) or 0
    duration: np.ndarray  # float32, beats
    velocity: np.ndarray  # float32
    valid: np.ndarray     # bool

    def __len__(self):
        return self.row.shape[0]

    def to(self, device) -> Tuple[torch.Tensor, ...]:
        """The six record arrays as tensors on ``device``, in
        ``segment_rasterize`` argument order."""
        return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                     for a in (self.row, self.note_idx, self.acc,
                               self.duration, self.velocity, self.valid))


def _pad_to(n: int, buckets=(512, 2048, 8192, 32768, 131072)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def encode_notes(rasterizer: Rasterizer, q: QNotes, channel_index: int,
                 pitched: bool, n_channels: int, n_bars: int,
                 valid_bars: Optional[int] = None,
                 sort: bool = True, first_bar: int = 0) -> DeviceNotes:
    """QNotes (one channel) -> flattened device records.

    Cell row = ((c * n_bars + bar) * n_beats + beat) * n_fractions + frac.
    ``n_bars`` is the (possibly padded) raster layout; ``valid_bars`` caps the
    bars actually written (the reference's prepare_input truncation,
    style/data.py:136-143). Out-of-range notes (the reference's ValueError
    skip, midi_conversion.py:495-498) are marked invalid.
    ``first_bar``: the raster holds song bars ``first_bar ..
    first_bar + n_bars`` (one seq rank's share); a note whose onset bar
    lies outside them is marked invalid, and ``valid_bars`` still counts
    from the song's first bar.
    """
    T = rasterizer.info.n_beats
    F10 = rasterizer.grid.n_fractions
    n_notes = rasterizer.n_notes(pitched)
    valid = (q.note_idx >= 0) & (q.note_idx < n_notes)
    last = first_bar + n_bars
    if valid_bars is not None:
        last = min(last, valid_bars)
    valid &= (q.bar >= first_bar) & (q.bar < last)
    bar = q.bar - first_bar
    row = ((channel_index * n_bars + bar) * T + q.beat) * F10 + q.frac_idx
    # invalid notes get a sentinel row: they sort to the end and lie outside
    # every raster
    row = np.where(valid, row, SENTINEL_ROW)
    duration = (q.duration / rasterizer.info.ticks_per_beat).astype(np.float32)
    out = DeviceNotes(
        row=row.astype(np.int32), note_idx=q.note_idx.astype(np.int32),
        acc=q.acc.astype(np.int32), duration=duration,
        velocity=q.velocity.astype(np.float32), valid=np.asarray(valid))
    if sort:
        order = np.argsort(out.row, kind="stable")
        out = DeviceNotes(*(a[order] for a in
                            (out.row, out.note_idx, out.acc, out.duration,
                             out.velocity, out.valid)))
    return out


def concat_and_pad(parts, pad_len: Optional[int] = None) -> DeviceNotes:
    """Concatenate per-channel DeviceNotes and pad to a bucketed static length."""
    row = np.concatenate([p.row for p in parts]) if parts else np.zeros(0, np.int32)
    note = np.concatenate([p.note_idx for p in parts]) if parts else row
    acc = np.concatenate([p.acc for p in parts]) if parts else row
    dur = np.concatenate([p.duration for p in parts]) if parts else \
        np.zeros(0, np.float32)
    vel = np.concatenate([p.velocity for p in parts]) if parts else dur
    valid = np.concatenate([p.valid for p in parts]) if parts else \
        np.zeros(0, bool)
    order = np.argsort(row, kind="stable")
    row, note, acc, dur, vel, valid = (a[order] for a in
                                       (row, note, acc, dur, vel, valid))
    n = _pad_to(len(row)) if pad_len is None else pad_len
    pad = n - len(row)
    if pad < 0:
        raise ValueError("pad_len smaller than note count")
    return DeviceNotes(
        row=np.pad(row, (0, pad), constant_values=SENTINEL_ROW).astype(np.int32),
        note_idx=np.pad(note, (0, pad)).astype(np.int32),
        acc=np.pad(acc, (0, pad)).astype(np.int32),
        duration=np.pad(dur, (0, pad)).astype(np.float32),
        velocity=np.pad(vel, (0, pad)).astype(np.float32),
        valid=np.pad(valid, (0, pad)),
    )


def segment_rasterize(row, note_idx, acc, duration, velocity, valid,
                      n_rows: int, n_notes: int, n_feat: int,
                      out_dtype=FP32):
    """Scatter-max rasterization -> (n_rows, n_notes * n_feat) at
    ``out_dtype`` (float32 or bfloat16).

    Semantics of the host Rasterizer.rasterize scatter
    (midi_conversion.py:490-516) and of mst_tpu's segment_rasterize: zero
    base, elementwise max on collision, accidental one-hot for pitched
    (n_feat == 5); a bf16 raster is the bf16 cast of the fp32 one. CUDA
    tensors run K1; CPU tensors its plain version."""
    return raster_kernel.rasterize(row, note_idx, acc, duration, velocity,
                                   valid, n_rows, n_notes, n_feat, out_dtype)


def _rasterize_records(dn: DeviceNotes, device, n_rows: int, n_notes: int,
                       n_feat: int, out_shape: tuple,
                       out_dtype) -> torch.Tensor:
    return segment_rasterize(*dn.to(device), n_rows, n_notes, n_feat,
                             out_dtype).reshape(out_shape)


def device_rasterize_song(rasterizer: Rasterizer, note_arrays, pitched: bool,
                          n_channels: int, n_bars: Optional[int] = None,
                          valid_bars: Optional[int] = None,
                          fuse_nf: bool = False, device="cuda",
                          out_dtype=FP32) -> torch.Tensor:
    """Device rasterization of one song's channels (mst_tpu's
    device_rasterize_song). ``note_arrays``: one NoteArray per channel.
    Returns (C, n_bars, T, F10, n_notes, F) on ``device``, or with
    ``fuse_nf`` the (note, feature) axes fused as one minor axis.
    ``n_bars`` defaults to the rasterizer's n_bars+1 (the quantization spill
    bar, parity midi_conversion.py:492-493)."""
    T = rasterizer.info.n_beats
    F10 = rasterizer.grid.n_fractions
    n_notes = rasterizer.n_notes(pitched)
    n_feat = rasterizer.n_features(pitched)
    if n_bars is None:
        n_bars = rasterizer.n_bars + 1
    parts = [encode_notes(rasterizer, rasterizer.quantize(notes, pitched), c,
                          pitched, n_channels, n_bars, valid_bars)
             for c, notes in enumerate(note_arrays)]
    tail = (n_notes * n_feat,) if fuse_nf else (n_notes, n_feat)
    return _rasterize_records(concat_and_pad(parts), device,
                              n_channels * n_bars * T * F10, n_notes, n_feat,
                              (n_channels, n_bars, T, F10) + tail, out_dtype)


def device_rasterize_batch(rasterizers, note_arrays_per_song, pitched: bool,
                           n_channels: int, n_bars: int, valid_bars,
                           fuse_nf: bool = False, device="cuda",
                           out_dtype=FP32, first_bar: int = 0
                           ) -> torch.Tensor:
    """B songs' channels in one K1 launch (mst_tpu's device_rasterize_batch).

    Each song keeps its own Rasterizer (its own tick grid and scale); batch
    index b folds into the flattened cell row as ``b * n_channels + c``
    leading channel blocks, so one (B*C*R*T*F10)-row scatter materializes
    the whole (B, C, R, T, F10, N, F) batch. All songs must share the
    beats-per-bar count (the caller groups by time signature).
    ``valid_bars``: per-song bar caps."""
    B = len(rasterizers)
    T = rasterizers[0].info.n_beats
    if any(r.info.n_beats != T for r in rasterizers):
        raise ValueError("batched songs must share beats-per-bar")
    F10 = rasterizers[0].grid.n_fractions
    n_notes = rasterizers[0].n_notes(pitched)
    n_feat = rasterizers[0].n_features(pitched)
    parts = []
    for b, (rast, note_arrays) in enumerate(zip(rasterizers,
                                                note_arrays_per_song)):
        for c, notes in enumerate(note_arrays[:n_channels]):
            parts.append(encode_notes(rast, rast.quantize(notes, pitched),
                                      b * n_channels + c, pitched,
                                      B * n_channels, n_bars, valid_bars[b],
                                      first_bar=first_bar))
    tail = (n_notes * n_feat,) if fuse_nf else (n_notes, n_feat)
    return _rasterize_records(concat_and_pad(parts), device,
                              B * n_channels * n_bars * T * F10, n_notes,
                              n_feat, (B, n_channels, n_bars, T, F10) + tail,
                              out_dtype)


def device_rasterize_batch_sharded(mesh, rasterizers, note_arrays_per_song,
                                   pitched: bool, n_channels: int,
                                   n_bars: int, valid_bars,
                                   fuse_nf: bool = False, device=None,
                                   out_dtype=FP32) -> torch.Tensor:
    """This rank's share of ``device_rasterize_batch`` over the global batch
    (mst_tpu's device_rasterize_batch_sharded): data rank ``r`` of ``n``
    encodes the notes of songs ``r*B_loc..(r+1)*B_loc`` alone and, as seq
    rank ``s`` of ``m``, only the notes whose onset lies in its bars
    ``s*R/m..(s+1)*R/m``, and launches K1 for them, writing the (B_loc, C,
    R/m, T, F10, ...) raster on its own device (``device``, by default the
    mesh's). The raster is bit-equal to the rank's slice of the whole
    batch's: a cell's max depends only on the notes of its own row.
    Raises ``ValueError`` unless ``n`` divides the batch and ``m`` the bar
    bucket; the songs must share beats-per-bar, as there."""
    mine = mesh.data_rows(len(rasterizers))
    bars = mesh.seq_bars(n_bars)
    if any(r.info.n_beats != rasterizers[0].info.n_beats
           for r in rasterizers):
        raise ValueError("batched songs must share beats-per-bar")
    return device_rasterize_batch(
        rasterizers[mine], note_arrays_per_song[mine], pitched, n_channels,
        bars.stop - bars.start, list(valid_bars)[mine], fuse_nf=fuse_nf,
        device=mesh.device if device is None else device,
        out_dtype=out_dtype, first_bar=bars.start)
