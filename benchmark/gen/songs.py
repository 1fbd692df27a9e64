"""The benchmark's input songs: synthetic MIDI made from a seed.

A copy of the repository's corpus generator (``tools/make_corpus.py``,
``generate_song``) that writes the Standard MIDI File bytes itself and
imports neither the JAX package nor the port, so that no change to either
package's MIDI code can change the benchmark's inputs. The songs have
diatonic chord progressions, motif-structured melodies, root-note bass,
arpeggios and rock/pop drums, with keys, modes, tempos, meters, programs
and lengths drawn from ``numpy.random.Generator``.

``song_bytes(info, instruments)`` encodes one song as a format-1 file of
one track: time signature, tempo, a program change per pitched channel,
the note messages in time order with running status, end of track at the
song's duration. ``make_pool(seed, n, keep)`` draws songs until ``n`` pass
the filter ``keep(summary)`` and returns their bytes and summaries.
"""

import struct

import numpy as np

# the 40 most common General MIDI programs of the reference's corpus
POPULAR_INSTRUMENTS = (
    0, 25, 48, 33, 1, 27, 49, 29, 35, 30, 50, 24, 5, 4, 32, 52, 26, 18, 28,
    89, 65, 53, 61, 2, 17, 73, 54, 62, 16, 39, 34, 51, 90, 56, 66, 38, 11,
    81, 3, 57,
)
# semitones of the seven degrees above the tonic
MAJOR_STEPS = (0, 2, 4, 5, 7, 9, 11)
MINOR_STEPS = (0, 2, 3, 5, 7, 8, 10)     # natural minor (Aeolian)

# diatonic triads on scale degrees (0-based) for common progressions
PROGRESSIONS = [
    [0, 3, 4, 0], [0, 5, 3, 4], [0, 4, 5, 3], [5, 3, 0, 4],
    [0, 3, 0, 4], [0, 1, 4, 0], [0, 5, 1, 4],
]

# rhythm templates: onset positions (in beats) within one bar, per grid kind.
# A SHARED library (not per-song randomness) so rhythmic structure repeats
# across the corpus — learnable regularity rather than incompressible noise.
RHYTHM_TEMPLATES_8TH = [
    [0, 0.5, 1, 1.5, 2, 2.5, 3, 3.5],
    [0, 1, 1.5, 2, 3, 3.5],
    [0, 0.5, 1, 2, 2.5, 3],
    [0, 1.5, 2, 3.5],
    [0, 0.5, 1.5, 2.5, 3],
    [0, 1, 2, 3],
]
RHYTHM_TEMPLATES_TRIPLET = [
    [0, 2.0 / 3, 4.0 / 3, 2, 8.0 / 3, 10.0 / 3],
    [0, 4.0 / 3, 2, 10.0 / 3],
    [0, 2.0 / 3, 2, 8.0 / 3],
]
# melodic contours as chord-tone offsets: 0/2/4 are chord tones (root, third,
# fifth above the current chord degree), odd values passing tones. Strong
# positions (template index 0 and midpoints) land on chord tones.
CONTOURS = [
    [0, 2, 4, 2, 0, 2, 4, 7],
    [4, 2, 0, 2, 4, 5, 4, 2],
    [0, 1, 2, 3, 4, 3, 2, 1],
    [7, 4, 2, 0, 2, 4, 2, 0],
    [0, 2, 4, 5, 7, 5, 4, 2],
    [4, 3, 2, 1, 0, 2, 4, 4],
]
# phrase structure for melody motifs: AABA
PHRASE = [0, 0, 1, 0]

# drum notes: kick, snare, closed hat, open hat, crash
KICK, SNARE, HAT, OHAT, CRASH = 36, 38, 42, 46, 49


def _notes_to_stream(notes, ticks_per_beat):
    """notes: list of (onset_beats, dur_beats, midi_note, velocity 0-1).
    Returns the on/off messages as (is_on, note, velocity, time) arrays,
    stably sorted by time."""
    n = len(notes)
    is_on = np.zeros(2 * n, bool)
    note = np.zeros(2 * n, np.int32)
    vel = np.zeros(2 * n, np.float64)
    time = np.zeros(2 * n, np.int64)
    for i, (onset, dur, key, v) in enumerate(notes):
        t_on = int(round(onset * ticks_per_beat))
        t_off = int(round((onset + dur) * ticks_per_beat))
        is_on[2 * i], note[2 * i] = True, key
        vel[2 * i], time[2 * i] = v, t_on
        is_on[2 * i + 1], note[2 * i + 1] = False, key
        vel[2 * i + 1], time[2 * i + 1] = 0.0, max(t_off, t_on + 1)
    order = np.argsort(time, kind="stable")
    return is_on[order], note[order], vel[order], time[order]


def _scale_notes(tonic, minor):
    steps = MINOR_STEPS if minor else MAJOR_STEPS
    return [tonic + i for i in steps]


def generate_song(rng: np.random.Generator, numer=None, n_bars=None,
                  n_pitched=None, drums=None):
    """One song: (info dict, [instrument dicts]) for ``song_bytes``.
    ``numer``, ``n_bars``, ``n_pitched`` and ``drums``, where given,
    replace the drawn beats per bar, bar count, pitched channel count and
    percussion choice (the draws are still made, so the rest of the song
    comes from the same stream)."""
    tonic = int(rng.integers(0, 12))
    minor = bool(rng.integers(0, 2))
    scale = _scale_notes(tonic, minor)
    drawn = int(rng.choice([4, 4, 4, 3], p=[0.6, 0.15, 0.15, 0.1]))
    numer = drawn if numer is None else int(numer)
    tempo_bpm = int(rng.integers(60, 181))
    tempo = int(round(6e7 / tempo_bpm))
    tpb = 480
    drawn = int(rng.integers(32, 160))
    n_bars = drawn if n_bars is None else int(n_bars)
    progression = PROGRESSIONS[rng.integers(0, len(PROGRESSIONS))]
    base_octave = 5  # MIDI C4=60 region

    def chord_pitches(degree, octave):
        out = []
        for k in (0, 2, 4):
            p = scale[(degree + k) % 7] + 12 * (octave + (degree + k) // 7)
            # harmonic minor: the V chord carries the raised leading tone
            # (E-G#-B in A minor) — this is what breaks the natural-minor /
            # relative-major pitch-class tie for the key detector, exactly
            # like real minor-mode writing does
            if minor and degree % 7 == 4 and k == 2:
                p += 1
            out.append(p)
        return out

    # one-bar lead-in: the TS/tempo meta events live at tick 0, and a
    # non-4/4 time signature coinciding with the first note would be
    # rejected as "changed mid-song" (style/midi_conversion.py:152-154
    # checks first_note <= t <= last_note; our parser matches)
    lead = numer

    drawn = int(rng.integers(2, 6))
    n_pitched = drawn if n_pitched is None else int(n_pitched)
    programs = rng.choice(POPULAR_INSTRUMENTS, size=n_pitched, replace=False)
    instruments = []
    channel_ids = [c for c in range(16) if c != 9]
    roles = ["melody", "chords", "bass"] + ["arp", "pad", "counter"]
    for ci in range(n_pitched):
        role = roles[ci] if ci < len(roles) else "arp"
        notes = []
        swing = rng.random() < 0.25  # triplet-grid songs exercise divisor 3
        if role == "melody":
            templates = (RHYTHM_TEMPLATES_TRIPLET if swing
                         else RHYTHM_TEMPLATES_8TH)
            motifs = []
            for _ in range(2):  # the song's A and B motifs
                steps = templates[rng.integers(0, len(templates))]
                contour = CONTOURS[rng.integers(0, len(CONTOURS))]
                motifs.append({"steps": steps,
                               "contour": contour[:len(steps)],
                               "dur": 2.0 / 3 if swing else 0.5})
        for bar in range(n_bars):
            t_bar = lead + bar * numer
            degree = progression[bar % len(progression)]
            if role == "melody":
                # motif-structured melody (learnable, NOT a random walk):
                # the song's 2 motifs repeat in an AABA phrase pattern,
                # anchored to the current chord degree, with chord-tone
                # contours and rare (10%) single-degree variations
                motif = motifs[PHRASE[bar % len(PHRASE)]]
                dur = motif["dur"]
                for s, off in zip(motif["steps"], motif["contour"]):
                    if s >= numer:
                        continue
                    if rng.random() < 0.1:  # occasional variation
                        off += int(rng.integers(-1, 2))
                    deg = degree + off
                    pitch = (scale[deg % 7]
                             + 12 * (base_octave + deg // 7))
                    # melodic leading tone over the V chord in minor
                    if minor and degree % 7 == 4 and deg % 7 == 6:
                        pitch += 1
                    accent = 0.15 if s == int(s) else 0.0
                    notes.append((t_bar + s, dur, pitch,
                                  0.5 + accent + 0.15 * rng.random()))
            elif role == "chords":
                for k, pitch in enumerate(chord_pitches(degree,
                                                        base_octave - 1)):
                    notes.append((t_bar, float(numer) * 0.9, pitch,
                                  0.35 + 0.2 * rng.random()))
            elif role == "bass":
                root = scale[degree % 7] + 12 * (base_octave - 2)
                for b in range(numer):
                    if rng.random() < 0.15:
                        continue
                    notes.append((t_bar + b, 0.9, root,
                                  0.5 + 0.3 * rng.random()))
            else:  # arp / pad / counter
                pitches = chord_pitches(degree, base_octave)
                for k in range(numer * 2):
                    if rng.random() < 0.4:
                        continue
                    notes.append((t_bar + k * 0.5, 0.4,
                                  pitches[k % 3],
                                  0.3 + 0.3 * rng.random()))
        if len(notes) < 60:  # pipeline drops channels with <100 messages
            continue
        instruments.append({
            "channel_id": channel_ids[len(instruments)],
            "instrument_id": int(programs[ci]),
            "messages": _notes_to_stream(notes, tpb),
        })

    drawn = rng.random() < 0.8  # most songs have drums
    if drawn if drums is None else drums:
        notes = []
        for bar in range(n_bars):
            t0 = lead + bar * numer
            if bar % 8 == 0:
                notes.append((t0, 0.5, CRASH, 0.7))
            for b in range(numer):
                if b % 2 == 0:
                    notes.append((t0 + b, 0.25, KICK,
                                  0.7 + 0.2 * rng.random()))
                else:
                    notes.append((t0 + b, 0.25, SNARE,
                                  0.6 + 0.2 * rng.random()))
                for h in (0.0, 0.5):
                    hat = OHAT if (b == numer - 1 and h == 0.5) else HAT
                    notes.append((t0 + b + h, 0.2, hat,
                                  0.35 + 0.2 * rng.random()))
        instruments.append({"channel_id": 9, "instrument_id": -1,
                            "messages": _notes_to_stream(notes, tpb)})

    info = {
        "ticks_per_beat": tpb,
        "ticks_per_bar": tpb * numer,
        "time_signature": {"numerator": numer, "denominator": 4},
        "tempo": tempo,
        "duration": (n_bars + 1) * numer * tpb,
    }
    return info, instruments



def _varlen(value, out):
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    out += bytes(reversed(chunks))


def song_bytes(info, instruments) -> bytes:
    """One song of ``generate_song`` as Standard MIDI File bytes (format 1,
    one track). Velocities are written as ``int(v * 127)`` in float32."""
    events = []      # (time, order, bytes)
    ts = info["time_signature"]
    head = bytearray()
    head += bytes((0x00, 0xFF, 0x58, 4, ts["numerator"],
                   ts["denominator"].bit_length() - 1, 24, 8))
    head += bytes((0x00, 0xFF, 0x51, 3)) + int(info["tempo"]).to_bytes(3, "big")
    times, statuses, keys, vels = [], [], [], []
    for inst in instruments:
        ch = inst["channel_id"]
        if ch != 9:
            head += bytes((0x00, 0xC0 | ch, inst["instrument_id"]))
        is_on, note, vel, time = inst["messages"]
        v = (vel.astype(np.float32) * np.float32(127)).astype(np.int64)
        times.append(time)
        statuses.append(np.where(is_on, 0x90, 0x80) | ch)
        keys.append(note.astype(np.int64))
        vels.append(v)
    body = bytearray(head)
    if times:
        time = np.concatenate(times)
        order = np.argsort(time, kind="stable")
        time = time[order]
        status = np.concatenate(statuses)[order]
        key = np.concatenate(keys)[order]
        vel = np.concatenate(vels)[order]
        prev = 0
        running = None
        for t, s, k, v in zip(time.tolist(), status.tolist(), key.tolist(),
                              vel.tolist()):
            _varlen(t - prev, body)
            prev = t
            if s != running:
                body.append(s)
                running = s
            body += bytes((k, v))
    else:
        prev = 0
    _varlen(max(int(info["duration"]) - prev, 0), body)
    body += bytes((0xFF, 0x2F, 0))
    return (b"MThd" + struct.pack(">IHHH", 6, 1, 1, info["ticks_per_beat"])
            + b"MTrk" + struct.pack(">I", len(body)) + bytes(body))


def summarize(info, instruments) -> dict:
    """What a cell's filter reads of a generated song."""
    pitched = [i for i in instruments if i["channel_id"] != 9]
    return {
        "numerator": info["time_signature"]["numerator"],
        "bars": int(info["duration"] // info["ticks_per_bar"]) - 1,
        "pitched_channels": len(pitched),
        "percussion": len(pitched) < len(instruments),
        "notes": int(sum(int(i["messages"][0].sum()) for i in pitched)),
        "drum_notes": int(sum(int(i["messages"][0].sum())
                              for i in instruments if i["channel_id"] == 9)),
    }


def make_pool(seed: int, n: int, keep=lambda summary: True,
              max_draws: int = 100000, sizes=None):
    """``n`` songs from ``numpy.random.default_rng(seed)`` that pass
    ``keep``: ([bytes], [summary]). Songs whose every channel fell under
    the note floor are skipped, as the original generator skips them.
    ``sizes``: None, or ``n`` dicts of ``generate_song``'s overrides, the
    i-th for the i-th song kept."""
    rng = np.random.default_rng(seed)
    out, summaries = [], []
    for _ in range(max_draws):
        info, instruments = generate_song(
            rng, **({} if sizes is None else sizes[len(out)]))
        if not instruments:
            continue
        summary = summarize(info, instruments)
        if keep(summary):
            out.append(song_bytes(info, instruments))
            summaries.append(summary)
            if len(out) == n:
                return out, summaries
    raise RuntimeError(f"only {len(out)} of {n} songs passed the filter "
                       f"in {max_draws} draws")
