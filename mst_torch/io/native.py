"""ctypes binding for the native SMF codec (native/midi_codec.cpp).

Loads ``native/libmidicodec.so`` when present (build: ``make -C native``) and
exposes parse/encode with the exact interface and semantics of the pure-Python
:mod:`mst_torch.io.smf`; falls back to it transparently when the library is
missing or rejects an input. Byte-level parity between the two implementations
is enforced by tests/test_native_codec.py.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from mst_torch.exceptions import MidiParseError
from mst_torch.io import smf

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "libmidicodec.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:  # built for another host: use the Python codec
        return None
    lib.midi_parse.restype = ctypes.c_void_p
    lib.midi_parse.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.midi_free_result.argtypes = [ctypes.c_void_p]
    for name in ("midi_result_format", "midi_result_tpb",
                 "midi_result_ntracks"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    lib.midi_track_len.restype = ctypes.c_int64
    lib.midi_track_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.midi_track_copy.restype = None
    lib.midi_track_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.midi_encode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.midi_encode.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.midi_free_buffer.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def parse_midi_bytes(data: bytes) -> smf.MidiFileData:
    """Native parse; raises MidiParseError on malformed input (same policy as
    the Python parser)."""
    lib = _load()
    if lib is None:
        return smf.parse_midi_bytes(data)
    handle = lib.midi_parse(data, len(data))
    if not handle:
        raise MidiParseError("native parser rejected file")
    try:
        n_tracks = lib.midi_result_ntracks(handle)
        tracks: List[smf.TrackEvents] = []
        for t in range(n_tracks):
            n = lib.midi_track_len(handle, t)
            type_ = np.empty(n, np.int32)
            delta = np.empty(n, np.int64)
            channel = np.empty(n, np.int32)
            a = np.empty(n, np.int32)
            b = np.empty(n, np.int32)
            if n:
                lib.midi_track_copy(
                    handle, t, _ptr(type_, ctypes.c_int32),
                    _ptr(delta, ctypes.c_int64), _ptr(channel, ctypes.c_int32),
                    _ptr(a, ctypes.c_int32), _ptr(b, ctypes.c_int32))
            tracks.append(smf.TrackEvents(type=type_, delta=delta,
                                          channel=channel, a=a, b=b))
        return smf.MidiFileData(format=lib.midi_result_format(handle),
                                ticks_per_beat=lib.midi_result_tpb(handle),
                                tracks=tracks)
    finally:
        lib.midi_free_result(handle)


def encode_midi(data: smf.MidiFileData) -> bytes:
    lib = _load()
    if lib is None:
        return smf.encode_midi(data)
    n_tracks = len(data.tracks)
    offsets = np.zeros(n_tracks + 1, np.int64)
    for i, t in enumerate(data.tracks):
        offsets[i + 1] = offsets[i] + len(t)
    type_ = np.ascontiguousarray(np.concatenate(
        [t.type for t in data.tracks]) if n_tracks else
        np.zeros(0, np.int32), dtype=np.int32)
    delta = np.ascontiguousarray(np.concatenate(
        [t.delta for t in data.tracks]) if n_tracks else
        np.zeros(0, np.int64), dtype=np.int64)
    channel = np.ascontiguousarray(np.concatenate(
        [t.channel for t in data.tracks]) if n_tracks else
        np.zeros(0, np.int32), dtype=np.int32)
    a = np.ascontiguousarray(np.concatenate(
        [t.a for t in data.tracks]) if n_tracks else
        np.zeros(0, np.int32), dtype=np.int32)
    b = np.ascontiguousarray(np.concatenate(
        [t.b for t in data.tracks]) if n_tracks else
        np.zeros(0, np.int32), dtype=np.int32)
    size = ctypes.c_size_t(0)
    buf = lib.midi_encode(
        data.format, data.ticks_per_beat, n_tracks,
        _ptr(offsets, ctypes.c_int64), _ptr(type_, ctypes.c_int32),
        _ptr(delta, ctypes.c_int64), _ptr(channel, ctypes.c_int32),
        _ptr(a, ctypes.c_int32), _ptr(b, ctypes.c_int32),
        ctypes.byref(size))
    if not buf:
        raise MidiParseError("native encoder rejected events")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.midi_free_buffer(buf)


def parse_midi_file(path) -> smf.MidiFileData:
    with open(path, "rb") as f:
        return parse_midi_bytes(f.read())


def write_midi_file(path, data: smf.MidiFileData) -> None:
    with open(path, "wb") as f:
        f.write(encode_midi(data))
