"""The fp32-boundary rule for comparing two ``.mid`` outputs.

Two runs of the same transfer on different hardware (or frameworks) sum
floats in different orders, so a cell whose velocity sits at the 0.01
hard-output gate, or whose ``v*127`` or ``d*tpb`` sits at an integer, may
land on either side. Two files pass when they are byte-equal or when every
difference is such a cell: the same tempo, time-signature and program facts,
note events matched one to one with velocity bytes within 1, and every
unmatched note event a borderline cell with velocity byte <= 2 (the 0.01
gate, model.py:818-832). This is the rule of
tests/test_e2e_reference_parity.py:241-273.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mst_torch.io import smf


def _note_events(data: smf.MidiFileData):
    """Absolute-time note events + header/meta facts of a parsed file."""
    notes, meta = [], []
    for track in data.tracks:
        t = np.cumsum(track.delta)
        for i in range(len(track)):
            ev = int(track.type[i])
            if ev in (smf.EV_NOTE_ON, smf.EV_NOTE_OFF):
                notes.append((int(t[i]), ev == smf.EV_NOTE_ON,
                              int(track.channel[i]), int(track.a[i]),
                              int(track.b[i])))
            elif ev in (smf.EV_TEMPO, smf.EV_TIME_SIG, smf.EV_PROGRAM):
                meta.append((ev, int(track.channel[i]), int(track.a[i]),
                             int(track.b[i])))
    return notes, meta, data.ticks_per_beat


def midi_differences(a: bytes, b: bytes) -> Tuple[bool, List[str], list]:
    """Compare two encoded ``.mid`` files under the boundary rule. Returns
    (byte_equal, faults, borderline): ``faults`` lists what breaks the rule
    (empty when the files pass), ``borderline`` the unmatched note events
    the rule accepts."""
    if a == b:
        return True, [], []
    a_notes, a_meta, a_tpb = _note_events(smf.parse_midi_bytes(a))
    b_notes, b_meta, b_tpb = _note_events(smf.parse_midi_bytes(b))
    faults = []
    if a_tpb != b_tpb:
        faults.append(f"ticks per beat {a_tpb} != {b_tpb}")
    if a_meta != b_meta:
        faults.append("meta/program facts differ")
    pool = {}
    for note in b_notes:
        pool.setdefault(note[:4], []).append(note[4])
    unmatched = []
    for time, is_on, ch, key, vel in a_notes:
        cands = pool.get((time, is_on, ch, key))
        if cands:
            best = min(range(len(cands)), key=lambda i: abs(cands[i] - vel))
            if abs(cands[best] - vel) <= 1:
                cands.pop(best)
                continue
        unmatched.append((time, is_on, ch, key, vel))
    unmatched += [(k + (v,)) for k, vs in pool.items() for v in vs]
    borderline = [n for n in unmatched if n[4] <= 2]
    hard = [n for n in unmatched if n[4] > 2]
    if hard:
        faults.append(f"{len(hard)} non-borderline note diffs, "
                      f"e.g. {hard[:5]}")
    return False, faults, borderline
