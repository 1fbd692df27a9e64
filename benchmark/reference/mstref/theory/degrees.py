"""Integer lookup tables: chromatic notes <-> scale-relative locations.

The reference maps each note through per-note Python calls
``note2scale_loc`` / ``scale_loc2key_octave`` (style/midi_conversion.py:244-283)
with dict lookups and float half-degrees. Here the same mapping is precomputed
once into small integer arrays, so the per-note transform becomes a vectorized
gather — runnable on the host (numpy) over whole songs.

Accidental encoding matches the feature layout of the dense tensor
(style/midi_conversion.py:504-510): index 0=flat, 1=none/natural, 2=sharp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from benchmark.reference.mstref.theory.scales import MAJOR, MINOR, Mode, relative_degree

ACC_FLAT, ACC_NONE, ACC_SHARP = 0, 1, 2

# parity: style/midi_conversion.py:235-241 — relative (major-scale) half-degrees
# that read as flats vs. sharps.
_DEGREE2ACC = {1.5: ACC_FLAT, 2.5: ACC_FLAT, 4.5: ACC_SHARP, 5.5: ACC_SHARP,
               6.5: ACC_FLAT}

_MODES = (MAJOR, MINOR)  # index 0 = major, 1 = minor (matches Scale.is_minor)


def _mode_tables(mode: Mode):
    """degree-1 (0..6) and accidental code for each interval 0..11 of ``mode``.

    Parity: style/midi_conversion.py:244-266 (note2scale_loc) — out-of-scale
    intervals pick the accidental from the *relative major* half-degree, then
    floor (sharp) / ceil (flat) the mode's own half-degree.
    """
    degree = np.zeros(12, dtype=np.int32)
    acc = np.zeros(12, dtype=np.int32)
    for interval in range(12):
        d = mode.degree_of(interval)
        if d == int(d):
            degree[interval] = int(d) - 1
            acc[interval] = ACC_NONE
        else:
            rel = relative_degree(interval, mode, MAJOR)
            a = _DEGREE2ACC[rel]
            acc[interval] = a
            degree[interval] = (math.floor(d) if a == ACC_SHARP else math.ceil(d)) - 1
    return degree, acc


def _inverse_table(mode: Mode):
    """(12 tonics, 7 degrees, 3 accidentals) -> semitone offset from the octave
    base (C of scale_octave 0 => note_id 12*(octave+1)+offset).

    Parity: style/midi_conversion.py:269-283 (scale_loc2key_octave) +
    :320-324 (note2note_id) — the reference wraps octave and key separately;
    folding both into one signed semitone offset is arithmetically identical.
    """
    table = np.zeros((12, 7, 3), dtype=np.int32)
    acc_delta = {ACC_FLAT: -1, ACC_NONE: 0, ACC_SHARP: 1}
    for tonic in range(12):
        for degree in range(7):
            for a, delta in acc_delta.items():
                table[tonic, degree, a] = mode.absolute_intervals[degree] + tonic + delta
    return table


@dataclasses.dataclass(frozen=True)
class DegreeTables:
    """All scale-relative LUTs, ready for vectorized gathers.

    fwd_degree[m, i]   : scale degree-1 for mode m (0=major,1=minor), interval i
    fwd_acc[m, i]      : accidental code for mode m, interval i
    inv_semitone[m, t, d, a] : semitone offset for mode m, tonic t, degree d, acc a
    """

    fwd_degree: np.ndarray   # (2, 12) int32
    fwd_acc: np.ndarray      # (2, 12) int32
    inv_semitone: np.ndarray  # (2, 12, 7, 3) int32

    def note_to_scale_loc(self, note_id, tonic, is_minor, xp=np):
        """Vectorized note2scale_loc. ``note_id`` any-shape int array; returns
        (scale_octave, degree0, acc) arrays (degree0 = degree-1 in 0..6).

        Parity: style/midi_conversion.py:244-266,309-317 — octave = note//12 - 1,
        decremented when the chromatic interval to the tonic is negative.
        """
        note_id = xp.asarray(note_id)
        m = xp.asarray(is_minor).astype(xp.int32)
        key = note_id % 12
        octave = note_id // 12 - 1
        interval = (key - tonic) % 12
        degree0 = xp.asarray(self.fwd_degree)[m, interval]
        acc = xp.asarray(self.fwd_acc)[m, interval]
        scale_octave = octave - (key < tonic).astype(octave.dtype)
        return scale_octave, degree0, acc

    def scale_loc_to_note(self, scale_octave, degree0, acc, tonic, is_minor, xp=np):
        """Vectorized scale_loc2key_octave + note2note_id -> chromatic note id."""
        m = xp.asarray(is_minor).astype(xp.int32)
        off = xp.asarray(self.inv_semitone)[m, tonic, degree0, acc]
        return 12 * (xp.asarray(scale_octave) + 1) + off


def note_id_to_key_octave(note_id: int):
    """Chromatic MIDI note -> (key index 0..11, octave) with octave -1 at
    note 0 (parity: note_id2key_octave, midi_conversion.py:309-317)."""
    return note_id % 12, note_id // 12 - 1


def key_octave_to_note_id(key_index: int, octave: int) -> int:
    """Inverse of :func:`note_id_to_key_octave` (parity: note2note_id,
    midi_conversion.py:320-324)."""
    return 12 * (octave + 1) + key_index


def _build() -> DegreeTables:
    fwd_degree = np.stack([_mode_tables(m)[0] for m in _MODES])
    fwd_acc = np.stack([_mode_tables(m)[1] for m in _MODES])
    inv = np.stack([_inverse_table(m) for m in _MODES])
    return DegreeTables(fwd_degree=fwd_degree, fwd_acc=fwd_acc, inv_semitone=inv)


degree_tables = _build()
