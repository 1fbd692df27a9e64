"""Standard MIDI File (SMF) codec — structure-of-arrays, mido-free.

The reference depends on ``mido`` for all file I/O (style/midi.py:6-7). This
framework ships its own codec so the whole ingestion path emits **SoA event
tensors** (type/delta/channel/a/b int arrays per track) instead of per-message
Python objects — the idiomatic-JAX departure that lets everything downstream be
vectorized (SURVEY.md §7.2). A native C++ implementation of the same format
lives in ``native/midi_codec.cpp`` (bound in :mod:`benchmark.reference.mstref.io.native`); this
module is the reference/pure-Python implementation and the fallback.

Error policy parity (style/midi.py:104-108): any malformed construct raises
:class:`MidiParseError`, and corpus iteration skips the file — mirroring mido's
OSError/ValueError/KeyError/EOFError/KeySignatureError set.

Event payload packing (columns ``a``/``b``):
  note_off/note_on/polytouch : a=note,       b=velocity/value
  control_change             : a=control,    b=value
  program_change             : a=program
  aftertouch                 : a=value
  pitchwheel                 : a=14-bit value (0..16383)
  set_tempo                  : a=tempo (microseconds per beat, 24-bit)
  time_signature             : a=numerator,  b=denominator (already 2**pow)
  key_signature              : a=sf (signed -7..7), b=mi (0/1)
  meta_other                 : a=meta type byte
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence

import numpy as np

from benchmark.reference.mstref.exceptions import MidiParseError

# event type codes (shared with the native codec — keep in sync)
EV_NOTE_OFF = 0
EV_NOTE_ON = 1
EV_POLYTOUCH = 2
EV_CONTROL = 3
EV_PROGRAM = 4
EV_AFTERTOUCH = 5
EV_PITCHWHEEL = 6
EV_SYSEX = 7
EV_TEMPO = 8
EV_TIME_SIG = 9
EV_KEY_SIG = 10
EV_END_OF_TRACK = 11
EV_META_OTHER = 12

_STATUS_TO_TYPE = {
    0x80: EV_NOTE_OFF, 0x90: EV_NOTE_ON, 0xA0: EV_POLYTOUCH,
    0xB0: EV_CONTROL, 0xC0: EV_PROGRAM, 0xD0: EV_AFTERTOUCH,
    0xE0: EV_PITCHWHEEL,
}
_TWO_BYTE = {0x80, 0x90, 0xA0, 0xB0, 0xE0}


@dataclasses.dataclass
class TrackEvents:
    """One track's events as parallel arrays (delta ticks, not absolute)."""

    type: np.ndarray     # int32 (N,)
    delta: np.ndarray    # int64 (N,)
    channel: np.ndarray  # int32 (N,), -1 for meta/sysex
    a: np.ndarray        # int32 (N,)
    b: np.ndarray        # int32 (N,)

    def __len__(self) -> int:
        return self.type.shape[0]


@dataclasses.dataclass
class MidiFileData:
    format: int
    ticks_per_beat: int
    tracks: List[TrackEvents]


def _read_varlen(data: bytes, pos: int):
    value = 0
    for _ in range(4):
        if pos >= len(data):
            raise MidiParseError("truncated variable-length quantity")
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos
    raise MidiParseError("variable-length quantity too long")


def _data_byte(data: bytes, pos: int) -> int:
    if pos >= len(data):
        raise MidiParseError("truncated event data")
    byte = data[pos]
    if byte > 127:
        # parity: mido validates data-byte range and raises ValueError, which
        # load_midi_from_file turns into a skipped file (style/midi.py:104-108)
        raise MidiParseError(f"data byte {byte} out of range")
    return byte


def _parse_track(data: bytes) -> TrackEvents:
    types, deltas, channels, a_col, b_col = [], [], [], [], []
    pos = 0
    running_status = None
    pending_delta = 0
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        pending_delta += delta
        if pos >= len(data):
            raise MidiParseError("truncated track")
        status = data[pos]
        if status >= 0x80:
            pos += 1
        else:
            if running_status is None:
                raise MidiParseError("running status without prior status byte")
            status = running_status

        if status == 0xFF:  # meta event
            running_status = None  # meta/sysex clear running status
            if pos >= len(data):
                raise MidiParseError("truncated meta event")
            meta_type = data[pos]
            pos += 1
            length, pos = _read_varlen(data, pos)
            if pos + length > len(data):
                raise MidiParseError("truncated meta payload")
            payload = data[pos:pos + length]
            pos += length
            if meta_type == 0x51:
                if length != 3:
                    raise MidiParseError("bad set_tempo length")
                ev, a, b = EV_TEMPO, int.from_bytes(payload, "big"), 0
            elif meta_type == 0x58:
                if length < 2:
                    raise MidiParseError("bad time_signature length")
                if payload[1] > 30:
                    raise MidiParseError("bad time_signature denominator")
                ev, a, b = EV_TIME_SIG, payload[0], 2 ** payload[1]
            elif meta_type == 0x59:
                if length < 2:
                    raise MidiParseError("bad key_signature length")
                sf = struct.unpack("b", payload[0:1])[0]
                if not -7 <= sf <= 7 or payload[1] > 1:
                    # parity: mido raises KeySignatureError here -> file skipped
                    raise MidiParseError("invalid key signature")
                ev, a, b = EV_KEY_SIG, sf, payload[1]
            elif meta_type == 0x2F:
                ev, a, b = EV_END_OF_TRACK, 0, 0
            else:
                ev, a, b = EV_META_OTHER, meta_type, 0
            types.append(ev); deltas.append(pending_delta)
            channels.append(-1); a_col.append(a); b_col.append(b)
            pending_delta = 0
            if ev == EV_END_OF_TRACK:
                break
        elif status in (0xF0, 0xF7):  # sysex — recorded, payload dropped
            running_status = None
            length, pos = _read_varlen(data, pos)
            if pos + length > len(data):
                raise MidiParseError("truncated sysex")
            pos += length
            types.append(EV_SYSEX); deltas.append(pending_delta)
            channels.append(-1); a_col.append(0); b_col.append(0)
            pending_delta = 0
        elif status >= 0xF1:
            raise MidiParseError(f"unexpected system message 0x{status:02x}")
        else:
            running_status = status
            kind = status & 0xF0
            channel = status & 0x0F
            a = _data_byte(data, pos); pos += 1
            if kind in _TWO_BYTE:
                b = _data_byte(data, pos); pos += 1
            else:
                b = 0
            if kind == 0xE0:
                a = a | (b << 7)  # 14-bit pitchwheel value
                b = 0
            types.append(_STATUS_TO_TYPE[kind]); deltas.append(pending_delta)
            channels.append(channel); a_col.append(a); b_col.append(b)
            pending_delta = 0
    return TrackEvents(
        type=np.array(types, dtype=np.int32),
        delta=np.array(deltas, dtype=np.int64),
        channel=np.array(channels, dtype=np.int32),
        a=np.array(a_col, dtype=np.int32),
        b=np.array(b_col, dtype=np.int32),
    )


def parse_midi_bytes(data: bytes) -> MidiFileData:
    if len(data) < 14 or data[:4] != b"MThd":
        raise MidiParseError("not a standard MIDI file")
    header_len = struct.unpack(">I", data[4:8])[0]
    if header_len < 6:
        raise MidiParseError("bad header length")
    fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise MidiParseError("SMPTE time division not supported")
    if division == 0:
        raise MidiParseError("zero time division")
    pos = 8 + header_len
    tracks: List[TrackEvents] = []
    for _ in range(ntracks):
        if pos + 8 > len(data):
            raise MidiParseError("truncated track header")
        if data[pos:pos + 4] != b"MTrk":
            raise MidiParseError("missing MTrk chunk")
        length = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        pos += 8
        if pos + length > len(data):
            raise MidiParseError("truncated track chunk")
        tracks.append(_parse_track(data[pos:pos + length]))
        pos += length
    return MidiFileData(format=fmt, ticks_per_beat=division, tracks=tracks)


def parse_midi_file(path) -> MidiFileData:
    with open(path, "rb") as f:
        return parse_midi_bytes(f.read())


def _write_varlen(value: int, out: bytearray) -> None:
    if value < 0:
        raise MidiParseError("negative delta time")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    out.extend(reversed(chunks))


def encode_midi(data: MidiFileData) -> bytes:
    """Serialize to SMF bytes. Matches mido's writer conventions
    (running-status compression for consecutive same-status channel events,
    minimal varlen encodings, time_signature clocks=24/32nds=8), so output is
    byte-identical to what the reference's create_midi + mido.save produced
    for the bundled examples (verified by round-trip tests)."""
    out = bytearray()
    out += b"MThd" + struct.pack(">IHHH", 6, data.format, len(data.tracks),
                                 data.ticks_per_beat)
    _CHANNEL_STATUS = {EV_NOTE_OFF: 0x80, EV_NOTE_ON: 0x90, EV_POLYTOUCH: 0xA0,
                       EV_CONTROL: 0xB0, EV_PROGRAM: 0xC0, EV_AFTERTOUCH: 0xD0,
                       EV_PITCHWHEEL: 0xE0}
    for track in data.tracks:
        body = bytearray()
        running_status = None  # mido writes with running status
        for i in range(len(track)):
            _write_varlen(int(track.delta[i]), body)
            ev = int(track.type[i]); a = int(track.a[i]); b = int(track.b[i])
            ch = int(track.channel[i]) & 0x0F
            if ev in _CHANNEL_STATUS:
                status = _CHANNEL_STATUS[ev] | ch
                if status != running_status:
                    body.append(status)
                    running_status = status
                if ev == EV_PITCHWHEEL:
                    body += bytes((a & 0x7F, (a >> 7) & 0x7F))
                elif ev in (EV_PROGRAM, EV_AFTERTOUCH):
                    body.append(a)
                else:
                    body += bytes((a, b))
                continue
            running_status = None
            if ev == EV_TEMPO:
                body += bytes((0xFF, 0x51, 3)) + int(a).to_bytes(3, "big")
            elif ev == EV_TIME_SIG:
                pow2 = int(b).bit_length() - 1
                if 2 ** pow2 != b:
                    raise MidiParseError("denominator must be a power of two")
                body += bytes((0xFF, 0x58, 4, a, pow2, 24, 8))
            elif ev == EV_KEY_SIG:
                body += bytes((0xFF, 0x59, 2)) + struct.pack("b", a) + bytes((b,))
            elif ev == EV_END_OF_TRACK:
                body += bytes((0xFF, 0x2F, 0))
            else:
                raise MidiParseError(f"cannot encode event type {ev}")
        out += b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    return bytes(out)


def write_midi_file(path, data: MidiFileData) -> None:
    with open(path, "wb") as f:
        f.write(encode_midi(data))


def track_from_lists(types: Sequence[int], deltas: Sequence[int],
                     channels: Sequence[int], a: Sequence[int],
                     b: Sequence[int]) -> TrackEvents:
    return TrackEvents(
        type=np.asarray(types, dtype=np.int32),
        delta=np.asarray(deltas, dtype=np.int64),
        channel=np.asarray(channels, dtype=np.int32),
        a=np.asarray(a, dtype=np.int32),
        b=np.asarray(b, dtype=np.int32),
    )
