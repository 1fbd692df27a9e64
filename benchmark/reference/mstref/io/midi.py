"""Instrument taxonomy + high-level MIDI load/synthesize API.

Parity target: style/midi.py. The General MIDI program table (128 programs in 16
named families, 47 percussion notes 35..81) is standard data; the 40 "popular"
pitched instruments are the reference's corpus-derived selection
(style/midi.py:23-64) and are kept identical so one-hot encodings line up.

Unlike the reference (mido Message objects), synthesis consumes SoA note-message
arrays (:class:`NoteStream`) and emits a :class:`~benchmark.reference.mstref.io.smf.MidiFileData`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from benchmark.reference.mstref.io import smf
from benchmark.reference.mstref.io.smf import (
    EV_NOTE_ON, EV_NOTE_OFF, EV_PROGRAM, EV_TEMPO, EV_TIME_SIG,
    EV_END_OF_TRACK, MidiFileData, TrackEvents,
)

DEFAULT_TEMPO = 500000   # microseconds per beat (style/midi.py:17)
DEFAULT_VOLUME = 96      # style/midi.py:18
MAX_VOLUME = 127
MAX_VELOCITY = 127

# --- General MIDI program table (standard data; parity: style/midi_programs.txt)
_GM_GROUPS = (
    "Piano", "Chromatic Percussion", "Organ", "Guitar", "Bass", "Strings",
    "Ensemble", "Brass", "Reed", "Pipe", "Synth Lead", "Synth Pad",
    "Synth Effects", "Ethnic", "Percussive", "Sound effects",
)
_GM_NAMES = (
    "Acoustic Grand Piano", "Bright Acoustic Piano", "Electric Grand Piano",
    "Honky-tonk Piano", "Electric Piano 1", "Electric Piano 2", "Harpsichord",
    "Clavinet",
    "Celesta", "Glockenspiel", "Music Box", "Vibraphone", "Marimba",
    "Xylophone", "Tubular Bells", "Dulcimer",
    "Drawbar Organ", "Percussive Organ", "Rock Organ", "Church Organ",
    "Reed Organ", "Accordion", "Harmonica", "Tango Accordion",
    "Acoustic Guitar (nylon)", "Acoustic Guitar (steel)",
    "Electric Guitar (jazz)", "Electric Guitar (clean)",
    "Electric Guitar (muted)", "Overdriven Guitar", "Distortion Guitar",
    "Guitar Harmonics",
    "Acoustic Bass", "Electric Bass (finger)", "Electric Bass (pick)",
    "Fretless Bass", "Slap Bass 1", "Slap Bass 2", "Synth Bass 1",
    "Synth Bass 2",
    "Violin", "Viola", "Cello", "Contrabass", "Tremolo Strings",
    "Pizzicato Strings", "Orchestral Harp", "Timpani",
    "String Ensemble 1", "String Ensemble 2", "Synth Strings 1",
    "Synth Strings 2", "Choir Aahs", "Voice Oohs", "Synth Choir",
    "Orchestra Hit",
    "Trumpet", "Trombone", "Tuba", "Muted Trumpet", "French Horn",
    "Brass Section", "Synth Brass 1", "Synth Brass 2",
    "Soprano Sax", "Alto Sax", "Tenor Sax", "Baritone Sax", "Oboe",
    "English Horn", "Bassoon", "Clarinet",
    "Piccolo", "Flute", "Recorder", "Pan Flute", "Blown bottle",
    "Shakuhachi", "Whistle", "Ocarina",
    "Lead 1 (square)", "Lead 2 (sawtooth)", "Lead 3 (calliope)",
    "Lead 4 (chiff)", "Lead 5 (charang)", "Lead 6 (voice)", "Lead 7 (fifths)",
    "Lead 8 (bass + lead)",
    "Pad 1 (new age)", "Pad 2 (warm)", "Pad 3 (polysynth)", "Pad 4 (choir)",
    "Pad 5 (bowed)", "Pad 6 (metallic)", "Pad 7 (halo)", "Pad 8 (sweep)",
    "FX 1 (rain)", "FX 2 (soundtrack)", "FX 3 (crystal)",
    "FX 4 (atmosphere)", "FX 5 (brightness)", "FX 6 (goblins)",
    "FX 7 (echoes)", "FX 8 (sci-fi)",
    "Sitar", "Banjo", "Shamisen", "Koto", "Kalimba", "Bagpipe", "Fiddle",
    "Shanai",
    "Tinkle Bell", "Agogo", "Steel Drums", "Woodblock", "Taiko Drum",
    "Melodic Tom", "Synth Drum", "Reverse Cymbal",
    "Guitar Fret Noise", "Breath Noise", "Seashore", "Bird Tweet",
    "Telephone Ring", "Helicopter", "Applause", "Gunshot",
)

PROGRAM_TO_INSTRUMENT: Dict[int, str] = {i: n for i, n in enumerate(_GM_NAMES)}
PROGRAM_TO_INSTRUMENT[-1] = "Percussion"
PROGRAM_TO_GROUP: Dict[int, str] = {
    i: _GM_GROUPS[i // 8] for i in range(len(_GM_NAMES))
}

# The 40 most common pitched GM programs in the Lakh corpus, in the reference's
# popularity order (style/midi.py:23-64) — kept identical for encoding parity.
POPULAR_INSTRUMENTS = (
    0, 25, 48, 33, 1, 27, 49, 29, 35, 30, 50, 24, 5, 4, 32, 52, 26, 18, 28,
    89, 65, 53, 61, 2, 17, 73, 54, 62, 16, 39, 34, 51, 90, 56, 66, 38, 11,
    81, 3, 57,
)


def get_instrument_id(program: int, channel: int = 0) -> int:
    """Channel 9 is always percussion (id -1). Parity: style/midi.py:90-93."""
    return -1 if channel == 9 else program


def is_sound_effect(instrument_id: int) -> bool:
    return instrument_id > 119


def is_pitched(instrument_id) -> bool:
    return bool(np.all(np.asarray(instrument_id) >= 0)) and not bool(
        np.any(np.asarray(instrument_id) > 119))


# --- tempo arithmetic (mido-compatible, used throughout the pipeline)

def tempo2bpm(tempo: float) -> float:
    return 60.0 * 1e6 / tempo


def bpm2tempo(bpm: float) -> int:
    return int(round(60.0 * 1e6 / bpm))


def tick2second(tick, ticks_per_beat: int, tempo: int):
    return tick * (tempo * 1e-6 / ticks_per_beat)


def second2tick(second, ticks_per_beat: int, tempo: int):
    return second / (tempo * 1e-6 / ticks_per_beat)


def load_midi_from_file(path) -> Optional[MidiFileData]:
    """Defensive load: None on any malformed file (parity: style/midi.py:104-108).
    The pure-Python parser alone: the yardstick never loads the
    program's native codec."""
    try:
        return smf.parse_midi_file(path)
    except (OSError, smf.MidiParseError):
        return None


@dataclasses.dataclass
class NoteStream:
    """SoA note-message stream for one instrument (on/off interleaved).

    ``velocity`` is normalized to (0, 1] as in the reference pipeline
    (style/midi_conversion.py:199); ``time`` is absolute ticks.
    """

    is_on: np.ndarray      # bool (N,)
    note: np.ndarray       # int32 (N,)
    velocity: np.ndarray   # float64 (N,)
    time: np.ndarray       # int64 (N,)

    def __len__(self) -> int:
        return self.is_on.shape[0]


def create_midi(info, *instruments, max_delta_time: float = math.inf,
                ) -> MidiFileData:
    """Synthesize a single-track MIDI file from instrument note streams.

    Parity: style/midi.py:120-168 — same track layout (time_signature,
    set_tempo, program_change per non-percussion channel, time-sorted note
    messages with per-message delta capping, end_of_track at song duration),
    same velocity rescale (x127) and ``max_delta_time`` semantics. ``info`` is a
    dict-like with ticks_per_beat, time_signature{numerator,denominator}, tempo,
    ticks_per_bar and optionally duration. Each instrument is a dict with
    ``channel_id``, ``instrument_id`` and a :class:`NoteStream` ``messages``.
    """
    max_dt = second2tick(max_delta_time, info["ticks_per_beat"], info["tempo"])
    if math.isfinite(max_dt):
        max_dt = int(max_dt)

    types, deltas, channels, a_col, b_col = [], [], [], [], []
    ts = info["time_signature"]
    types.append(EV_TIME_SIG); deltas.append(0); channels.append(-1)
    a_col.append(ts["numerator"]); b_col.append(ts["denominator"])
    types.append(EV_TEMPO); deltas.append(0); channels.append(-1)
    a_col.append(info["tempo"]); b_col.append(0)

    all_time, all_note, all_vel, all_on, all_channel = [], [], [], [], []
    for instrument in instruments:
        if instrument["channel_id"] != 9:
            types.append(EV_PROGRAM); deltas.append(0)
            channels.append(instrument["channel_id"])
            a_col.append(instrument["instrument_id"]); b_col.append(0)
        msgs: NoteStream = instrument["messages"]
        # velocity scaling happens in float32 (parity: style/midi.py:147 —
        # ``int(msg.velocity * 127)`` where msg.velocity is an np.float32 off
        # the torch decode path, so the multiply rounds in float32; a float64
        # multiply lands one ULP lower on exact-ratio values like 96/127 and
        # truncates to byte-1)
        velocity = (msgs.velocity.astype(np.float32)
                    * np.float32(MAX_VELOCITY)).astype(np.int64)
        if np.any(velocity > 127):
            raise ValueError("velocity out of range")
        all_time.append(msgs.time.astype(np.int64))
        all_note.append(msgs.note.astype(np.int64))
        all_vel.append(velocity)
        all_on.append(msgs.is_on.astype(bool))
        all_channel.append(np.full(len(msgs), instrument["channel_id"],
                                   dtype=np.int64))

    time = np.concatenate(all_time) if all_time else np.zeros(0, dtype=np.int64)
    note = np.concatenate(all_note) if all_note else time
    vel = np.concatenate(all_vel) if all_vel else time
    is_on = (np.concatenate(all_on) if all_on
             else np.zeros(0, dtype=bool))
    channel = np.concatenate(all_channel) if all_channel else time

    order = np.argsort(time, kind="stable")
    time, note, vel, is_on, channel = (
        time[order], note[order], vel[order], is_on[order], channel[order])

    if "duration" in info:
        duration = int(info["duration"])
    elif len(time) == 0:
        # the reference would IndexError here (style/midi.py:158); an empty
        # song becomes one silent bar instead
        duration = int(info["ticks_per_bar"])
    else:
        duration = int(time[-1]) + int(info["ticks_per_bar"])

    # delta encoding with per-message capping (style/midi.py:161-167)
    abs_times = np.concatenate([time, [duration]])
    prev = np.concatenate([[0], abs_times[:-1]])
    dts = abs_times - prev
    if math.isfinite(max_dt):
        dts = np.minimum(dts, max_dt)
    dts = np.maximum(dts, 0)

    head = len(types)
    track = smf.TrackEvents(
        type=np.concatenate([
            np.asarray(types, np.int32),
            np.where(is_on, EV_NOTE_ON, EV_NOTE_OFF).astype(np.int32),
            [EV_END_OF_TRACK]]),
        delta=np.concatenate([
            np.asarray(deltas, np.int64), dts]).astype(np.int64),
        channel=np.concatenate([
            np.asarray(channels, np.int32), channel.astype(np.int32),
            [-1]]),
        a=np.concatenate([
            np.asarray(a_col, np.int32), note.astype(np.int32), [0]]),
        b=np.concatenate([
            np.asarray(b_col, np.int32), vel.astype(np.int32), [0]]),
    )
    assert len(track.delta) == head + len(time) + 1
    return MidiFileData(format=1, ticks_per_beat=int(info["ticks_per_beat"]),
                        tracks=[track])
