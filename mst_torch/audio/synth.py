"""MIDI -> audio rendering (additive synthesis) for the audio-side eval path.

A numpy copy of mst_tpu/audio/synth.py with its imports rewritten; its PCM
is bit-equal to mst_tpu's. Each note becomes a bank of decaying harmonics
with an ADSR-ish envelope; percussion becomes band-filtered noise bursts
(WAV I/O and the filter through scipy). Quality target is "spectrally
representative", not musical fidelity — it feeds mel-spectrogram
similarity (mst_torch.audio.spectral), not ears.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mst_torch.io.midi import tick2second
from mst_torch.ops.events import NoteArray, pair_notes

SAMPLE_RATE = 22050
_HARMONICS = np.array([1.0, 0.5, 0.25, 0.125])


def note_to_hz(note_id) -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(note_id, dtype=np.float64) - 69) / 12)


def render_notes(notes: NoteArray, ticks_per_beat: int, tempo: int,
                 pitched: bool = True, sample_rate: int = SAMPLE_RATE,
                 total_seconds: Optional[float] = None) -> np.ndarray:
    """SoA notes -> mono float32 PCM."""
    if len(notes) == 0:
        return np.zeros(int((total_seconds or 1.0) * sample_rate), np.float32)
    onset = tick2second(notes.time, ticks_per_beat, tempo)
    dur = np.maximum(tick2second(notes.duration, ticks_per_beat, tempo), 0.02)
    end = onset + dur
    if total_seconds is None:
        total_seconds = float(end.max()) + 0.5
    out = np.zeros(int(total_seconds * sample_rate) + 1, np.float64)
    if pitched:
        _render_pitched(out, onset, dur, notes.note_id,
                        notes.velocity, sample_rate)
    else:
        _render_unpitched(out, onset, dur, notes.note_id, notes.velocity,
                          sample_rate)
    peak = np.abs(out).max()
    if peak > 0:
        out = out / max(peak, 1.0)
    return out.astype(np.float32)


# bound on summed segment samples processed per vectorized block: keeps the
# flat (sample, note-index) temporaries ~hundreds of MB even for dense
# multi-minute songs while still amortizing the numpy dispatch
_CHUNK_SAMPLES = 4 << 20


def _render_pitched(out, onset, dur, note_id, velocity, sample_rate) -> None:
    """Flat overlap-add additive synthesis — no per-note Python loop (a
    per-note loop makes dense multi-minute songs crawl).

    Two levers make it fast on one core:
    - the harmonic stack depends ONLY on note_id, so one float64 prototype
      wave is rendered per unique pitch (~tens, vs thousands of notes) and
      every note gathers a slice of it — the transcendental count drops by
      the pitch-reuse factor;
    - the per-sample remainder (envelope, velocity, scatter-add) runs in
      float32 over a flat (sum-of-note-lengths,) index space, chunked to
      bound memory. Matches the per-note loop to ~1e-5 of peak (float32
      envelope + addition order where notes overlap)."""
    n = (dur * sample_rate).astype(np.int64)
    start = (onset * sample_rate).astype(np.int64)
    keep = n > 0
    n, start = n[keep], start[keep]
    dur, note_id = dur[keep], np.asarray(note_id)[keep]
    velocity = np.asarray(velocity)[keep]
    if n.size == 0:
        return

    # prototype bank: longest needed waveform per unique pitch (float64 sin,
    # same skip-inaudible-harmonics rule as the reference loop), stored f32
    uniq, inv = np.unique(note_id, return_inverse=True)
    maxlen = np.zeros(uniq.size, np.int64)
    np.maximum.at(maxlen, inv, n)
    poff = np.concatenate(([0], np.cumsum(maxlen)))
    proto = np.empty(int(poff[-1]), np.float32)
    nyq = sample_rate / 2
    for u in range(uniq.size):
        L = int(maxlen[u])
        t = np.arange(L) / sample_rate
        f0 = float(note_to_hz(uniq[u]))
        w = np.zeros(L)
        for h, amp in enumerate(_HARMONICS, start=1):
            if f0 * h < nyq:
                w += amp * np.sin(2 * np.pi * (f0 * h) * t)
        proto[poff[u]:poff[u + 1]] = w

    note_poff = poff[inv].astype(np.int64)       # prototype offset per note
    vel32 = velocity.astype(np.float32)
    decay32 = (3.0 / np.maximum(dur, 1e-3)).astype(np.float32)
    csum = np.concatenate(([0], np.cumsum(n)))
    chunk = int(min(csum[-1], _CHUNK_SAMPLES))
    longest = int(n.max())

    # scratch arena, allocated ONCE: per-chunk numpy allocations of tens of
    # MB go through mmap and re-fault every page every chunk
    # (measured ~10-15 s of fault time per dense song); out=/template-memcpy
    # into these buffers makes the loop allocation-free
    cap = max(chunk, longest)
    w_tmpl = np.arange(cap, dtype=np.int64)          # within-note offsets
    t_tmpl = (w_tmpl * (1.0 / sample_rate)).astype(np.float32)
    gidx = np.empty(cap, np.int64)                   # prototype gather index
    pos = np.empty(cap, np.int64)                    # output sample index
    wave = np.empty(cap, np.float32)
    t32 = np.empty(cap, np.float32)
    env = np.empty(cap, np.float32)
    xbuf = np.empty(cap, np.float32)
    dvrep = np.empty(cap, np.float32)                # decay, then velocity

    i0 = 0
    while i0 < n.size:
        i1 = int(np.searchsorted(csum, csum[i0] + chunk, "right"))
        i1 = max(i1 - 1, i0 + 1)
        S = int(csum[i1] - csum[i0])
        for k in range(i0, i1):                      # template fills per note
            a = int(csum[k] - csum[i0])
            b = a + int(n[k])
            nk = b - a
            gidx[a:b] = w_tmpl[:nk]
            np.add(gidx[a:b], note_poff[k], out=gidx[a:b])
            pos[a:b] = w_tmpl[:nk]
            np.add(pos[a:b], start[k], out=pos[a:b])
            t32[a:b] = t_tmpl[:nk]
            dvrep[a:b] = decay32[k]
        np.take(proto, gidx[:S], out=wave[:S])
        # env = min(1, t/0.01) * exp(-t * 3/dur)
        np.multiply(t32[:S], np.float32(100.0), out=env[:S])
        np.minimum(env[:S], np.float32(1.0), out=env[:S])
        np.multiply(t32[:S], dvrep[:S], out=xbuf[:S])
        np.negative(xbuf[:S], out=xbuf[:S])
        np.exp(xbuf[:S], out=xbuf[:S])
        np.multiply(env[:S], xbuf[:S], out=env[:S])
        np.multiply(wave[:S], env[:S], out=wave[:S])
        for k in range(i0, i1):
            a = int(csum[k] - csum[i0])
            dvrep[a:a + int(n[k])] = vel32[k]
        np.multiply(wave[:S], dvrep[:S], out=wave[:S])
        if int(pos[:S].max()) >= len(out):           # tail past the buffer:
            # zero the overflow weights BEFORE clamping their positions
            np.multiply(wave[:S], pos[:S] < len(out), out=wave[:S],
                        casting="unsafe")
            np.minimum(pos[:S], len(out) - 1, out=pos[:S])
        out += np.bincount(pos[:S], weights=wave[:S], minlength=len(out))
        i0 = i1


def _render_unpitched(out, onset, dur, note_id, velocity,
                      sample_rate) -> None:
    """Noise bursts with a crude per-drum tilt (higher notes -> brighter).
    Per-note loop retained on purpose: each note is a fresh rng draw plus
    one lfilter call (already sample-vectorized), and drum-note counts are
    small next to pitched-note sample counts."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(0)
    for i in range(len(onset)):
        n = int(dur[i] * sample_rate)
        if n <= 0:
            continue
        start = int(onset[i] * sample_rate)
        t = np.arange(n) / sample_rate
        env = np.minimum(1.0, t / 0.01) * np.exp(-3.0 * t / max(dur[i], 1e-3))
        wave = rng.standard_normal(n)
        alpha = min(0.95, 0.3 + 0.01 * int(note_id[i]))
        # one-pole y[j] = alpha*x[j] + (1-alpha)*y[j-1], y[0] = x[0]
        wave = lfilter([alpha], [1.0, -(1.0 - alpha)], wave,
                       zi=np.array([(1.0 - alpha) * wave[0]]))[0]
        seg = wave * env * float(velocity[i])
        out[start:start + n] += seg[:max(0, len(out) - start)]


def render_midi(midi_data, sample_rate: int = SAMPLE_RATE,
                max_seconds: float = None) -> np.ndarray:
    """Parsed MidiFileData -> mono PCM: all channels rendered and mixed.

    ``max_seconds`` truncates the render — the bundled mp3 renditions are
    ~30 s excerpts, so comparing against them only needs the opening."""
    from mst_torch.ops.events import read_midi
    from mst_torch.io.midi import is_pitched
    channels, info = read_midi(midi_data)
    total = tick2second(info.duration, info.ticks_per_beat, info.tempo) + 0.5
    if max_seconds is not None:
        total = min(total, float(max_seconds))
    mix = np.zeros(int(total * sample_rate) + 1, np.float64)
    for ch in channels:
        notes = pair_notes(ch["messages"])
        pcm = render_notes(notes, info.ticks_per_beat, info.tempo,
                           pitched=is_pitched(ch["instrument_id"]),
                           sample_rate=sample_rate, total_seconds=total)
        mix[:len(pcm)] += pcm
    peak = np.abs(mix).max()
    if peak > 0:
        mix = mix / peak
    return mix.astype(np.float32)


def write_wav(path, pcm: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    from scipy.io import wavfile
    wavfile.write(path, sample_rate, (np.clip(pcm, -1, 1) * 32767
                                      ).astype(np.int16))
