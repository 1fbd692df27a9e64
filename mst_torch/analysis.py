"""Offline corpus-analysis helpers (parity: style/midi_conversion.py:327-346
get_notes_dist / get_keys_dist + style/data.py:117-119 keys_dists2df).

SoA equivalents: duration*velocity mass per note / per key, in seconds, with
instrument metadata — used to eyeball corpora and to feed
mst_torch.utils.data.list2df tables like the reference's notebooks did.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mst_torch.io.midi import tick2second
from mst_torch.ops.events import NoteArray, SongInfo
from mst_torch.theory import KEY_NAMES


def notes_dist(info: SongInfo, notes: NoteArray, instrument_name: str = "",
               instrument_id: int = 0) -> Dict:
    """Per (key name, octave) seconds of duration*velocity mass
    (parity: get_notes_dist, midi_conversion.py:327-337)."""
    weights = notes.duration.astype(np.float64) * notes.velocity
    seconds = tick2second(weights, info.ticks_per_beat, info.tempo)
    # one bincount over (octave, key) codes instead of a per-note Python loop
    code = notes.note_id.astype(np.int64)  # octave*12 + key, octave offset +1
    mass = np.bincount(code, weights=seconds, minlength=128)
    present = np.flatnonzero(mass)
    out: Dict = {(KEY_NAMES[int(c % 12)], int(c // 12) - 1): float(mass[c])
                 for c in present}
    out["instrument"] = instrument_name
    out["instrument_id"] = instrument_id
    return out


def keys_dist(info: SongInfo, notes: NoteArray,
              instrument_name: str = "") -> Dict:
    """Per key-name seconds of duration*velocity mass
    (parity: get_keys_dist, midi_conversion.py:340-346)."""
    weights = notes.duration.astype(np.float64) * notes.velocity
    seconds = tick2second(weights, info.ticks_per_beat, info.tempo)
    mass = np.zeros(12)
    np.add.at(mass, notes.note_id % 12, seconds)
    out: Dict = {KEY_NAMES[i]: float(mass[i]) for i in range(12) if mass[i]}
    out["instrument"] = instrument_name
    return out


def keys_dist_vector(notes: NoteArray) -> np.ndarray:
    """(12,) un-normalized key-mass vector (the detection-path aggregate,
    style/data.py:79-84 without the constant seconds factor). Thin wrapper
    over the one canonical implementation in mst_torch.theory."""
    from mst_torch.theory import keys_dist_from_notes
    return keys_dist_from_notes(
        notes.note_id % 12, notes.duration.astype(np.float64) * notes.velocity)
