"""Note arrays <-> dense piano-roll tensors (the representation core).

Parity target: style/midi_conversion.py:349-609 (ChannelConverter). The
reference loops over Note objects, building nested Python lists of per-beat
ndarrays; here each direction is a single vectorized pass:

- **rasterize**: scale-LUT gather + grid quantization + one ``np.maximum.at``
  scatter into the dense ``(bar, beat, fraction, note, feature)`` tensor
  (collision = elementwise max, parity :514).
- **derasterize**: one ``np.nonzero`` gather (C-order matches the reference's
  bar->beat->fraction->note iteration order exactly) + inverse LUTs.

The same scatter-max for on-device, batched rasterization lives in
:mod:`benchmark.reference.mstref.ops.device_raster` (a CUDA kernel, mst_torch/csrc/raster.cu).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from benchmark.reference.mstref.config import RepresentationConfig
from benchmark.reference.mstref.io.midi import NoteStream
from benchmark.reference.mstref.ops.events import NoteArray, SongInfo
from benchmark.reference.mstref.ops.quantize import FractionGrid, quantize_onsets
from benchmark.reference.mstref.theory import degree_tables
from benchmark.reference.mstref.theory.scales import Scale

# feature indices of the pitched representation (duration, velocity, flat,
# natural, sharp — style/midi_conversion.py:368,504-510); unpitched uses the
# first two only.
F_DURATION, F_VELOCITY, F_FLAT, F_NATURAL, F_SHARP = range(5)


@dataclasses.dataclass
class QNotes:
    """Quantized notes in grid coordinates (SoA)."""

    bar: np.ndarray        # int64
    beat: np.ndarray       # int64
    frac_idx: np.ndarray   # int32
    note_idx: np.ndarray   # int32  (raster row: pitched 0..55 / unpitched 0..46)
    duration: np.ndarray   # int64 ticks (qduration)
    velocity: np.ndarray   # float64
    acc: np.ndarray        # int32 accidental code (pitched only)

    def __len__(self) -> int:
        return self.bar.shape[0]


class Rasterizer:
    """Per-song converter between note arrays and dense channel tensors.

    Equivalent of the reference's ChannelConverter (midi_conversion.py:349-),
    bound to one song's :class:`SongInfo` (incl. detected scale).
    """

    def __init__(self, info: SongInfo, rep: RepresentationConfig = RepresentationConfig()):
        self.info = info
        self.rep = rep
        self.grid = FractionGrid.create(rep.beat_divisors)
        assert self.grid.n_fractions == rep.n_beat_fractions

    # --- scale accessors (parity: midi_conversion.py:575-581)
    @property
    def scale(self) -> Scale:
        assert self.info.scale is not None, "scale not detected yet"
        return self.info.scale

    @property
    def n_bars(self) -> int:
        import math
        return math.ceil(self.info.n_bars)

    def n_notes(self, pitched: bool) -> int:
        return self.rep.n_pitched_notes if pitched else self.rep.n_unpitched_notes

    def n_features(self, pitched: bool) -> int:
        return (self.rep.n_pitched_features if pitched
                else self.rep.n_unpitched_features)

    def raster_shape(self, pitched: bool) -> Tuple[int, ...]:
        # +1 bar: quantization may round an onset into a new final bar
        # (parity: midi_conversion.py:492-493)
        return (self.n_bars + 1, self.info.n_beats, self.grid.n_fractions,
                self.n_notes(pitched), self.n_features(pitched))

    # --- forward: notes -> dense tensor

    def quantize(self, notes: NoteArray, pitched: bool) -> QNotes:
        """Scale-map + grid-quantize (parity: nchannel2kchannel +
        kchannel2qchannel, midi_conversion.py:408-456)."""
        qtime, bar, beat, frac_idx = quantize_onsets(
            notes.time, self.info.ticks_per_beat, self.info.ticks_per_bar,
            self.grid)
        qduration = notes.end_time - qtime
        if pitched:
            scale = self.scale
            octave, degree0, acc = degree_tables.note_to_scale_loc(
                notes.note_id, scale.tonic, scale.is_minor)
            note_idx = octave * 7 + degree0
        else:
            note_idx = notes.note_id.astype(np.int64) - self.rep.min_percussion
            acc = np.zeros(len(notes), dtype=np.int32)
        return QNotes(bar=bar, beat=beat, frac_idx=frac_idx,
                      note_idx=note_idx.astype(np.int32),
                      duration=qduration.astype(np.int64),
                      velocity=notes.velocity.astype(np.float64),
                      acc=acc.astype(np.int32))

    def rasterize(self, notes: NoteArray, pitched: bool,
                  out: Optional[np.ndarray] = None,
                  dtype=np.float64) -> np.ndarray:
        """Dense (n_bars+1, n_beats, n_fractions, n_notes, n_features) tensor
        (parity: qchannel2vchannel, midi_conversion.py:490-516; out-of-range
        note rows are dropped like the reference's ValueError skip :495-498).

        ``out``: optional preallocated zeroed target (e.g. a channel slice of a
        song tensor) to scatter into directly. A float32 target is bit-equal to
        computing in float64 and casting (the scatter writes/maxes the same
        values)."""
        q = self.quantize(notes, pitched)
        shape = self.raster_shape(pitched)
        if out is None:
            out = np.zeros(shape, dtype=dtype)
        assert out.shape == shape, (out.shape, shape)
        valid = (q.note_idx >= 0) & (q.note_idx < self.n_notes(pitched))
        valid &= (q.bar >= 0) & (q.bar < shape[0])
        if not valid.any():
            return out
        bar, beat, frac, nidx = (q.bar[valid], q.beat[valid],
                                 q.frac_idx[valid], q.note_idx[valid])
        duration = q.duration[valid] / self.info.ticks_per_beat
        velocity = q.velocity[valid]
        features = np.zeros((bar.shape[0], shape[-1]), dtype=np.float64)
        features[:, F_DURATION] = duration
        features[:, F_VELOCITY] = velocity
        if pitched:
            features[np.arange(bar.shape[0]), F_FLAT + q.acc[valid]] = 1.0
        np.maximum.at(out, (bar, beat, frac, nidx), features)
        return out

    # --- inverse: dense tensor -> notes -> messages

    def derasterize(self, vchannel: np.ndarray, pitched: bool,
                    hard: bool = False) -> QNotes:
        """Gather nonzero-velocity cells back into quantized notes (parity:
        vchannel2qchannel, midi_conversion.py:518-562 — including its
        accidental precedence flat > natural > sharp > none and
        ``int(duration * ticks_per_beat)`` truncation).

        ``hard=True`` fuses hard_output thresholding (model.py:818-832) into
        the sparse gather: cells with velocity <= .01 are dropped and
        accidentals are argmax-gated at .1 on the gathered cells only —
        identical results to thresholding the dense tensor first, without
        copying it."""
        velocity = vchannel[..., F_VELOCITY]
        mask = velocity > 0.01 if hard else velocity != 0
        bar, beat, frac, nidx = np.nonzero(mask)  # C-order == loop order
        cells = vchannel[bar, beat, frac, nidx]
        duration = (cells[..., F_DURATION] * self.info.ticks_per_beat
                    ).astype(np.int64)
        if pitched:
            acc_feat = cells[..., F_FLAT:F_SHARP + 1]
            if hard:
                acc_feat = ((acc_feat == acc_feat.max(axis=-1, keepdims=True))
                            & (acc_feat > 0.1))
            flat = acc_feat[..., 0] != 0
            natural = acc_feat[..., 1] != 0
            sharp = acc_feat[..., 2] != 0
            acc = np.where(flat, 0, np.where(natural, 1, np.where(sharp, 2, 1)))
        else:
            acc = np.zeros(bar.shape, dtype=np.int64)
        return QNotes(bar=bar.astype(np.int64), beat=beat.astype(np.int64),
                      frac_idx=frac.astype(np.int32),
                      note_idx=nidx.astype(np.int32),
                      duration=duration,
                      velocity=cells[..., F_VELOCITY],
                      acc=acc.astype(np.int32))

    def derasterize_packed(self, dur_ticks: np.ndarray, vel_byte: np.ndarray,
                           acc: np.ndarray, pitched: bool) -> QNotes:
        """Packed device output (uint16 ticks, uint8 velocity-byte, uint8 acc
        code per cell, one channel) -> quantized notes. Bit-identical to
        derasterize() on the float tensor the packing came from: vel_byte is
        int(v*127) (exactly what create_midi writes) and dur_ticks is the
        int(d*tpb) truncation (midi_conversion.py:558)."""
        bar, beat, frac, nidx = np.nonzero(vel_byte)
        return QNotes(
            bar=bar.astype(np.int64), beat=beat.astype(np.int64),
            frac_idx=frac.astype(np.int32), note_idx=nidx.astype(np.int32),
            duration=dur_ticks[bar, beat, frac, nidx].astype(np.int64),
            velocity=vel_byte[bar, beat, frac, nidx].astype(np.float64) / 127.0,
            acc=acc[bar, beat, frac, nidx].astype(np.int32))

    def qnotes_to_messages(self, q: QNotes, pitched: bool) -> NoteStream:
        """Quantized notes -> interleaved on/off message stream, stably sorted
        by time (parity: qchannel2channel, midi_conversion.py:458-488)."""
        frac_ticks = self.grid.frac_ticks(self.info.ticks_per_beat)
        time = (q.bar * self.info.ticks_per_bar
                + q.beat * self.info.ticks_per_beat
                + frac_ticks[q.frac_idx])
        if pitched:
            octave = q.note_idx // 7
            degree0 = q.note_idx % 7
            scale = self.scale
            note_id = degree_tables.scale_loc_to_note(
                octave.astype(np.int64), degree0.astype(np.int64),
                q.acc.astype(np.int64), scale.tonic, scale.is_minor)
        else:
            note_id = q.note_idx.astype(np.int64) + self.rep.min_percussion

        n = len(q)
        # interleave [on_0, off_0, on_1, off_1, ...] then stable-sort by time,
        # reproducing the reference's message ordering exactly
        times = np.empty(2 * n, dtype=np.int64)
        times[0::2] = time
        times[1::2] = time + q.duration
        notes = np.repeat(note_id.astype(np.int32), 2)
        vels = np.zeros(2 * n, dtype=np.float64)
        vels[0::2] = q.velocity
        is_on = np.zeros(2 * n, dtype=bool)
        is_on[0::2] = True
        order = np.argsort(times, kind="stable")
        return NoteStream(is_on=is_on[order], note=notes[order],
                          velocity=vels[order], time=times[order])

    def messages_from_raster(self, vchannel: np.ndarray, pitched: bool,
                             hard: bool = False) -> NoteStream:
        """vchannel2channel composite (parity: midi_conversion.py:570-573)."""
        return self.qnotes_to_messages(
            self.derasterize(vchannel, pitched, hard=hard), pitched)
