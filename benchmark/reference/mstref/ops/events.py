"""Event-stream processing: SMF tracks -> merged timeline -> channels + song info.

Parity target: style/midi_conversion.py:31-232 (merge_tracks, split_channels,
get_midi_info, group_channel_messages, read_midi). The reference walks Python
lists of mido messages; here every stage is a vectorized transform over the SoA
event arrays from :mod:`benchmark.reference.mstref.io.smf`:

- global timeline = per-track cumulative sums + one stable argsort,
- per-channel program/volume state = boolean-mask forward fills,
- note pairing = a "next event of the same note" computation via a stable
  (note, position) sort,

so a whole file's ingestion is O(N log N) array work instead of per-message
Python, and the note output is already in the SoA layout the rasterizer and the
device pipeline consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference.mstref.exceptions import MidiFormatError
from benchmark.reference.mstref.io.midi import (
    DEFAULT_TEMPO, DEFAULT_VOLUME, MAX_VELOCITY, MAX_VOLUME, NoteStream,
    PROGRAM_TO_INSTRUMENT, tempo2bpm,
)
from benchmark.reference.mstref.io.smf import (
    EV_CONTROL, EV_KEY_SIG, EV_NOTE_OFF, EV_NOTE_ON, EV_PROGRAM, EV_TEMPO,
    EV_TIME_SIG, MidiFileData,
)

MAX_MSG_TIME = 1e7  # parity: style/midi_conversion.py:52


@dataclasses.dataclass
class EventStream:
    """A time-ordered SoA event stream (absolute ticks)."""

    type: np.ndarray     # int32
    time: np.ndarray     # int64, absolute ticks
    channel: np.ndarray  # int32, -1 for meta
    a: np.ndarray        # int32
    b: np.ndarray        # int32

    def __len__(self) -> int:
        return self.type.shape[0]

    def take(self, idx) -> "EventStream":
        return EventStream(self.type[idx], self.time[idx], self.channel[idx],
                           self.a[idx], self.b[idx])


def merge_tracks(data: MidiFileData) -> EventStream:
    """All tracks merged onto one global timeline, stably time-sorted, with
    absurdly late events dropped (parity: style/midi_conversion.py:37-66)."""
    if not data.tracks:
        return EventStream(*(np.zeros(0, dtype=np.int64) for _ in range(5)))
    types = np.concatenate([t.type for t in data.tracks])
    times = np.concatenate([np.cumsum(t.delta) for t in data.tracks])
    channels = np.concatenate([t.channel for t in data.tracks])
    a = np.concatenate([t.a for t in data.tracks])
    b = np.concatenate([t.b for t in data.tracks])
    order = np.argsort(times, kind="stable")
    stream = EventStream(types[order], times[order], channels[order],
                         a[order], b[order])
    return stream.take(stream.time <= MAX_MSG_TIME)


def split_channels(stream: EventStream) -> Tuple[EventStream, List[EventStream]]:
    """Global (meta) events + one stream per MIDI channel, channels ordered by
    first occurrence (parity: style/midi_conversion.py:55-66 — defaultdict
    insertion order)."""
    is_meta = stream.channel < 0
    global_events = stream.take(is_meta)
    channel_events = stream.take(~is_meta)
    channels: List[EventStream] = []
    _, first_pos = np.unique(channel_events.channel, return_index=True)
    for pos in np.sort(first_pos):
        ch = channel_events.channel[pos]
        channels.append(channel_events.take(channel_events.channel == ch))
    return global_events, channels


@dataclasses.dataclass
class SongInfo:
    """Song-level metadata (parity: the info dict of midi_conversion.py:131-179).

    ``scale`` is attached later by the data pipeline (style/data.py:85-86).
    """

    ticks_per_beat: int
    numerator: int
    denominator: int
    key_signature: Optional[Tuple[int, int]]
    duration: Optional[int]
    ticks_per_bar: int
    n_bars: float
    n_beats: int
    tempo2time: Dict[int, int]
    tempo: int
    bpm: int
    scale: Optional[object] = None  # theory.Scale

    @property
    def time_signature(self):
        return {"numerator": self.numerator, "denominator": self.denominator,
                "value": self.numerator / self.denominator}

    def as_create_midi_info(self) -> dict:
        """Info dict for create_midi. ``duration=None`` (a combined style+melody
        info, style_transfer.py:134-142) is omitted so create_midi falls back to
        last-message-time + one bar (style/midi.py:158)."""
        info = {
            "ticks_per_beat": self.ticks_per_beat,
            "time_signature": {"numerator": self.numerator,
                               "denominator": self.denominator},
            "tempo": self.tempo,
            "ticks_per_bar": self.ticks_per_bar,
        }
        if self.duration is not None:
            info["duration"] = self.duration
        return info


def get_midi_info(global_events: EventStream, channels: List[EventStream],
                  ticks_per_beat: int) -> SongInfo:
    """Parity: style/midi_conversion.py:117-179.

    Tempo histogram over note-playing time picks the dominant tempo;
    time-signature / key-signature changes *during the song* (between first and
    last note_on) raise MidiFormatError.
    """
    if not channels:
        raise MidiFormatError("no channel messages")
    note_on_times = np.concatenate([
        ch.time[(ch.type == EV_NOTE_ON) & (ch.b > 0)] for ch in channels])
    if note_on_times.size == 0:
        # The reference would die with a bare ValueError on min() here
        # (midi_conversion.py:125); raising MidiFormatError keeps the
        # defensive skip-the-file behavior consistent instead.
        raise MidiFormatError("song has no notes")
    first_note = int(note_on_times.min())
    last_note = int(note_on_times.max())
    duration = int(max(int(ch.time.max()) for ch in channels if len(ch)))

    # Vectorized meta-event scan (the reference loops every message in
    # Python, midi_conversion.py:131-177). Each meta type is an independent
    # state machine whose running value after event i is exactly event i's
    # value, so "value changed" == "differs from the previous event of the
    # same type" (with the default prepended) — one shifted compare per type
    # instead of a per-event Python loop, which matters on tempo-map-heavy
    # files.
    g_type = np.asarray(global_events.type)
    g_time = np.asarray(global_events.time)
    g_a = np.asarray(global_events.a)
    g_b = np.asarray(global_events.b)
    in_song_all = (g_time >= first_note) & (g_time <= last_note)

    numerator, denominator = 4, 4
    ts = g_type == EV_TIME_SIG
    if ts.any():
        ts_a, ts_b = g_a[ts], g_b[ts]
        changed = ((ts_a != np.concatenate(([numerator], ts_a[:-1])))
                   | (ts_b != np.concatenate(([denominator], ts_b[:-1]))))
        if np.any(changed & in_song_all[ts]):
            raise MidiFormatError("Time signature changed")
        numerator, denominator = int(ts_a[-1]), int(ts_b[-1])

    key_sig = None
    ks = g_type == EV_KEY_SIG
    if ks.any():
        ks_a, ks_b = g_a[ks], g_b[ks]
        changed = ((ks_a != np.concatenate(([ks_a[0]], ks_a[:-1])))
                   | (ks_b != np.concatenate(([ks_b[0]], ks_b[:-1]))))
        changed[0] = True  # first key signature always sets the value
        if np.any(changed & in_song_all[ks]):
            raise MidiFormatError("Key signature changed")
        key_sig = (int(ks_a[-1]), int(ks_b[-1]))

    tempo = DEFAULT_TEMPO
    tempo_change_time = 0
    tempo2time: Dict[int, int] = {}
    te = g_type == EV_TEMPO
    te_a, te_t = g_a[te], g_time[te]
    # only actual tempo CHANGES touch the histogram; dict insertion order is
    # preserved (it breaks max() ties below, matching the reference)
    for i in np.flatnonzero(
            te_a != np.concatenate(([tempo], te_a[:-1]))):
        t = int(te_t[i])
        tempo2time[tempo] = tempo2time.get(tempo, 0) + t - tempo_change_time
        tempo = int(te_a[i])
        tempo_change_time = t

    ticks_per_bar = int(ticks_per_beat * numerator)
    tempo2time[tempo] = tempo2time.get(tempo, 0) + duration - tempo_change_time
    tempo2time = {k: v for k, v in tempo2time.items() if v}
    if not tempo2time:
        tempo2time = {tempo: 0}
    # first max wins, matching Python max() over insertion-ordered items
    best_tempo = max(tempo2time.items(), key=lambda kv: kv[1])[0]

    return SongInfo(
        ticks_per_beat=int(ticks_per_beat),
        numerator=numerator,
        denominator=denominator,
        key_signature=key_sig,
        duration=duration,
        ticks_per_bar=ticks_per_bar,
        n_bars=duration / ticks_per_bar,
        n_beats=numerator,
        tempo2time=tempo2time,
        tempo=int(best_tempo),
        bpm=round(tempo2bpm(best_tempo)),
    )


def _forward_fill(values: np.ndarray, mask: np.ndarray, default: int) -> np.ndarray:
    """values[i] if mask[i] else most recent masked value before i, else default."""
    idx = np.where(mask, np.arange(values.shape[0]), -1)
    idx = np.maximum.accumulate(idx)
    out = np.where(idx >= 0, values[np.maximum(idx, 0)], default)
    return out


def group_channel_messages(events: EventStream, channel_id: int,
                           ) -> Dict[int, NoteStream]:
    """Fold program/volume state into per-note velocities and split the
    channel's notes by instrument id (parity: midi_conversion.py:182-210).

    The reference's sequential state machine becomes two forward fills
    (program, volume) plus a grouped selection. Message order within each
    instrument group is preserved.
    """
    is_note = (events.type == EV_NOTE_ON) | (events.type == EV_NOTE_OFF)
    program = _forward_fill(events.a, events.type == EV_PROGRAM, 0)
    volume = _forward_fill(
        events.b, (events.type == EV_CONTROL) & (events.a == 7), DEFAULT_VOLUME)

    note_idx = np.nonzero(is_note)[0]
    if note_idx.size == 0:
        return {}
    note = events.a[note_idx]
    raw_vel = events.b[note_idx].astype(np.float64)
    vol = volume[note_idx].astype(np.float64)
    velocity = raw_vel * vol / (MAX_VELOCITY * MAX_VOLUME)
    is_on = (events.type[note_idx] == EV_NOTE_ON) & (velocity != 0)
    time = events.time[note_idx]
    if channel_id == 9:
        instrument = np.full(note_idx.shape, -1, dtype=np.int64)
    else:
        instrument = program[note_idx].astype(np.int64)

    out: Dict[int, NoteStream] = {}
    seen = []
    for ins in instrument:
        if ins not in seen:
            seen.append(int(ins))
    for ins in seen:
        sel = instrument == ins
        out[ins] = NoteStream(
            is_on=is_on[sel],
            note=note[sel].astype(np.int32),
            velocity=velocity[sel],
            time=time[sel].astype(np.int64),
        )
    return out


def read_midi(data: MidiFileData) -> Tuple[List[dict], SongInfo]:
    """Parity: style/midi_conversion.py:216-232 — channel dicts (channel_id,
    instrument_id, instrument_name, messages) for every (channel, instrument)
    pair with at least one note_on, in first-occurrence order."""
    global_events, channel_streams = split_channels(merge_tracks(data))
    info = get_midi_info(global_events, channel_streams, data.ticks_per_beat)
    channels: List[dict] = []
    for ch_events in channel_streams:
        channel_id = int(ch_events.channel[0])
        grouped = group_channel_messages(ch_events, channel_id)
        for instrument_id, messages in grouped.items():
            if bool(messages.is_on.any()):
                channels.append({
                    "channel_id": channel_id,
                    "instrument_id": instrument_id,
                    "instrument_name": PROGRAM_TO_INSTRUMENT[instrument_id],
                    "messages": messages,
                })
    return channels, info


@dataclasses.dataclass
class NoteArray:
    """SoA notes of one (merged) channel: the output of note pairing and the
    input to scale-mapping/quantization/rasterization.

    Parity: the Note dataclass fields the reference carries per note
    (style/midi_conversion.py:286-306), minus derived fields computed later.
    """

    note_id: np.ndarray    # int32 (N,) chromatic MIDI note (or percussion note)
    time: np.ndarray       # int64 (N,) onset ticks
    end_time: np.ndarray   # int64 (N,)
    velocity: np.ndarray   # float64 (N,) normalized (0, 1]

    @property
    def duration(self) -> np.ndarray:
        return self.end_time - self.time

    def __len__(self) -> int:
        return self.note_id.shape[0]

    def take(self, idx) -> "NoteArray":
        return NoteArray(self.note_id[idx], self.time[idx], self.end_time[idx],
                         self.velocity[idx])


def pair_notes(messages: NoteStream) -> NoteArray:
    """note_on/note_off pairing (parity: midi_conversion.py:371-406).

    The reference tracks one open note per note id in a dict: *any* subsequent
    event on the same note id closes the open note at its time. Equivalently,
    each note_on's end_time is the time of the next same-note event (of either
    type), or its own time if none follows. Computed via one stable sort by
    (note, position); output notes stay in note_on order.
    """
    n = len(messages)
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return NoteArray(empty.astype(np.int32), empty, empty,
                         np.zeros(0, dtype=np.float64))
    pos = np.arange(n)
    order = np.lexsort((pos, messages.note))  # stable: by note, then position
    nxt_time = np.empty(n, dtype=np.int64)
    sorted_note = messages.note[order]
    sorted_time = messages.time[order]
    same_as_next = np.zeros(n, dtype=bool)
    same_as_next[:-1] = sorted_note[:-1] == sorted_note[1:]
    nxt_sorted = np.where(same_as_next,
                          np.concatenate([sorted_time[1:], [0]]),
                          sorted_time)
    nxt_time[order] = nxt_sorted

    on = messages.is_on
    return NoteArray(
        note_id=messages.note[on].astype(np.int32),
        time=messages.time[on].astype(np.int64),
        end_time=nxt_time[on],
        velocity=messages.velocity[on],
    )


def merge_note_arrays(arrays: List[NoteArray]) -> NoteArray:
    """Concatenate channels with the same instrument and stably sort by onset
    (parity: style/data.py:103-114)."""
    merged = NoteArray(
        note_id=np.concatenate([a.note_id for a in arrays]),
        time=np.concatenate([a.time for a in arrays]),
        end_time=np.concatenate([a.end_time for a in arrays]),
        velocity=np.concatenate([a.velocity for a in arrays]),
    )
    order = np.argsort(merged.time, kind="stable")
    return merged.take(order)
