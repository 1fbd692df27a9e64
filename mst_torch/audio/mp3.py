"""MPEG-1 Layer III decode through the system's ``libmpg123.so.0``.

A ctypes copy of mst_tpu/audio/mp3.py. The reference ships offline-rendered
mp3s of its golden examples; this module decodes such files to float32 PCM
so the audio eval (audio/spectral.py) can compare them with native
synthesis. It is not on the device path.

:func:`available` reports whether the library loads; callers skip when it
does not; without it ``load_mp3`` raises :class:`Mp3Unavailable`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

# mpg123.h constants (enum mpg123_errors / mpg123_enc_enum)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_ENC_FLOAT_32 = 0x200
_ENC_SIGNED_16 = 0xD0


class Mp3Unavailable(RuntimeError):
    """libmpg123 could not be loaded."""


@functools.lru_cache(maxsize=1)
def _lib():
    try:
        lib = ctypes.CDLL("libmpg123.so.0")
    except OSError as e:  # pragma: no cover - a host without the lib
        raise Mp3Unavailable(str(e))
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.restype = ctypes.c_int
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_close.restype = ctypes.c_int
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()  # no-op on modern versions; required on old ones
    return lib


def available() -> bool:
    """True if the system libmpg123 loads (tests/tools gate on this)."""
    try:
        _lib()
        return True
    except Mp3Unavailable:
        return False


def load_mp3(path: str, mono: bool = True,
             sample_rate: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """Decode an mp3 file to float32 PCM.

    Returns ``(pcm, rate)`` — ``pcm`` shaped ``(samples,)`` when ``mono``
    (channel mean) else ``(samples, channels)``. ``sample_rate``: optionally
    band-limited-resample the result (the bundled mp3s are 48 kHz; the
    native synthesiser — audio/synth.py — renders 22.05 kHz, and mel
    comparisons need one rate).
    """
    lib = _lib()
    err = ctypes.c_int(0)
    mh = lib.mpg123_new(None, ctypes.byref(err))
    if not mh:
        raise Mp3Unavailable(f"mpg123_new failed (code {err.value})")
    try:
        if lib.mpg123_open(mh, path.encode()) != _MPG123_OK:
            raise IOError(f"mpg123 could not open {path!r}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(mh, ctypes.byref(rate),
                                ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise IOError(f"mpg123 could not read format of {path!r}")
        # Decode at the NEGOTIATED encoding (mpg123's default is signed 16;
        # re-pinning after open does not take effect for the already-locked
        # stream — verified empirically against this library build) and
        # convert in numpy. A mid-stream NEW_FORMAT re-queries.
        chunks = []
        buf = (ctypes.c_char * (1 << 18))()
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(mh, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append((enc.value, bytes(buf[:done.value])))
            if ret == _MPG123_DONE:
                break
            if ret == _MPG123_NEW_FORMAT:
                new_rate = ctypes.c_long(0)
                lib.mpg123_getformat(mh, ctypes.byref(new_rate),
                                     ctypes.byref(channels),
                                     ctypes.byref(enc))
                if new_rate.value != rate.value:
                    raise IOError(
                        f"mid-stream sample-rate change in {path!r}")
                continue
            if ret not in (_MPG123_OK, _MPG123_NEED_MORE):
                raise IOError(f"mpg123_read error {ret} on {path!r}")
    finally:
        lib.mpg123_close(mh)
        lib.mpg123_delete(mh)

    def to_float(enc_val: int, raw: bytes) -> np.ndarray:
        if enc_val == _ENC_SIGNED_16:
            return np.frombuffer(raw, dtype="<i2").astype(np.float32) \
                / 32768.0
        if enc_val == _ENC_FLOAT_32:
            return np.frombuffer(raw, dtype=np.float32)
        raise IOError(f"unsupported mpg123 encoding {enc_val:#x}")

    pcm = (np.concatenate([to_float(e, raw) for e, raw in chunks])
           if chunks else np.zeros(0, np.float32))
    if channels.value > 1:
        pcm = pcm.reshape(-1, channels.value)
        if mono:
            pcm = pcm.mean(axis=1)
    out_rate = int(rate.value)
    if sample_rate is not None and sample_rate != out_rate:
        pcm = resample(pcm, out_rate, sample_rate)
        out_rate = sample_rate
    return np.ascontiguousarray(pcm, dtype=np.float32), out_rate


def resample(pcm: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Band-limited (FFT) resampling of a whole clip.

    Exact spectrum truncation/zero-padding — ideal low-pass for a finite
    clip, which is all the offline eval needs (no streaming use)."""
    if rate_in == rate_out:
        return pcm
    if pcm.ndim != 1:
        return np.stack([resample(pcm[:, c], rate_in, rate_out)
                         for c in range(pcm.shape[1])], axis=1)
    n_in = pcm.shape[0]
    n_out = int(round(n_in * rate_out / rate_in))
    spec = np.fft.rfft(pcm)
    n_keep = min(len(spec), n_out // 2 + 1)
    out_spec = np.zeros(n_out // 2 + 1, dtype=spec.dtype)
    out_spec[:n_keep] = spec[:n_keep]
    out = np.fft.irfft(out_spec, n=n_out) * (n_out / n_in)
    return out.astype(np.float32)
