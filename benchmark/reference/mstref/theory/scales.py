"""Music-theory core: keys, diatonic modes, Krumhansl-style key detection.

Parity target: style/scales.py. The reference scores 24 (key x major/minor)
candidates with a Python loop that rotates the key-duration distribution one
semitone per candidate (style/scales.py:197-211) and combines
``loss = cross_entropy * (1.5 - coverage) * (2 - loose_coverage)``
(style/scales.py:188), picking the argmin (style/scales.py:214-221).

Here the whole scoring is one vectorized (24, 12) computation with no Python
loops, in numpy float64, and batchable over many songs at once
(`detect_scales_batch`) — key detection for a whole batch of songs is a
couple of (24,12)x(12,) contractions.

Note: the reference additionally computes an ``ndcg`` score via an import of the
unavailable ``py_utils`` package (style/scales.py:203 — a latent bug; the value is
never used in the loss). We reproduce the *behavior* (the loss above) and omit the
dead ndcg computation.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

KEY_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")
KEY_TO_INTERVAL = {k: i for i, k in enumerate(KEY_NAMES)}
N_KEYS = len(KEY_NAMES)

MODE_NAMES = (
    "Ionian", "Dorian", "Phrygian", "Lydian", "Mixolydian", "Aeolian", "Locrian",
)


@dataclasses.dataclass(frozen=True)
class Mode:
    """A cyclic diatonic interval pattern (parity: style/scales.py:27-92).

    ``intervals``: 7 successive steps summing to 12. ``shift``: rotation relative
    to the major (Ionian) pattern; used for naming and for relative-degree maps.
    """

    intervals: Tuple[int, ...]
    shift: int = 0

    @property
    def name(self) -> str:
        return MODE_NAMES[self.shift % len(MODE_NAMES)]

    @property
    def tonic_intervals(self) -> Tuple[int, ...]:
        """Cumulative intervals, length 8: [0, i0, i0+i1, ... 12]."""
        acc = [0]
        for step in self.intervals:
            acc.append(acc[-1] + step)
        return tuple(acc)

    @property
    def absolute_intervals(self) -> Tuple[int, ...]:
        """The 7 in-scale semitone offsets from the tonic."""
        return self.tonic_intervals[:7]

    def degree_of(self, interval: int) -> float:
        """Scale degree (1..7) of a semitone offset; out-of-scale offsets map to
        ``previous_degree + 0.5`` (parity: style/scales.py:54-63,85-89)."""
        interval %= 12
        table = self._degree_table()
        return table[interval]

    def _degree_table(self):
        table = {}
        for degree, off in enumerate(self.absolute_intervals):
            table[off] = degree + 1
        prev = 1
        out = []
        for interval in range(12):
            if interval in table:
                prev = table[interval]
                out.append(float(prev))
            else:
                out.append(prev + 0.5)
        return out

    def rotated(self, shift: int) -> "Mode":
        """Parity: style/scales.py:95-97 (create_mode)."""
        iv = self.intervals
        s = shift % len(iv)
        return Mode(iv[s:] + iv[:s], shift)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.name} mode"


MAJOR = Mode((2, 2, 1, 2, 2, 2, 1))
MINOR = MAJOR.rotated(-2)  # Aeolian: (2,1,2,2,1,2,2), shift=-2
ALL_MODES = tuple(MAJOR.rotated(s) for s in range(len(MODE_NAMES)))


def _normalize_dist(dist: np.ndarray) -> np.ndarray:
    """Parity: style/utils/math.py:4-11 — uniform fallback on zero total."""
    dist = np.asarray(dist, dtype=np.float64)
    total = dist.sum()
    if total > 0:
        return dist / total
    return np.full_like(dist, 1.0 / dist.shape[-1])


# Krumhansl-Kessler key profiles (parity: style/scales.py:111-115)
MAJOR_PROFILE = _normalize_dist(
    np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
)
MINOR_PROFILE = _normalize_dist(
    np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17])
)

# In-scale offsets and the looser "typically used" offsets
# (parity: style/scales.py:119-124)
MAJOR_INTERVALS = np.array(MAJOR.absolute_intervals)
MINOR_INTERVALS = np.array(MINOR.absolute_intervals)
TYPICAL_MAJOR_INTERVALS = np.array([0, 2, 4, 5, 6, 7, 9, 10, 11])
TYPICAL_MINOR_INTERVALS = np.array([0, 1, 2, 3, 5, 7, 8, 9, 10, 11])

_CE_EPS = 1e-12  # parity: style/utils/metrics.py:4


@dataclasses.dataclass(frozen=True)
class Scale:
    """A detected scale: tonic key index (0=C..11=B) + major/minor flag."""

    tonic: int
    is_minor: bool
    loss: float = 0.0

    @property
    def key_name(self) -> str:
        return KEY_NAMES[self.tonic]

    @property
    def mode(self) -> Mode:
        return MINOR if self.is_minor else MAJOR

    @property
    def mode_name(self) -> str:
        return "minor" if self.is_minor else "major"

    def __repr__(self) -> str:  # pragma: no cover
        return f"Scale({self.key_name} {self.mode_name})"


def _candidate_masks():
    """(24, 12) binary masks for coverage / loose coverage, and (24, 12) profiles.

    Row order matches the reference's candidate order: 12 major keys C..B then 12
    minor keys C..B (style/scales.py:178-184), so argmin tie-breaking is identical
    (Python ``min`` keeps the first minimum; argmin does too).
    """
    cov = np.zeros((24, 12))
    loose = np.zeros((24, 12))
    prof = np.zeros((24, 12))
    for r in range(12):
        cov[r, MAJOR_INTERVALS] = 1.0
        loose[r, TYPICAL_MAJOR_INTERVALS] = 1.0
        prof[r] = MAJOR_PROFILE
        cov[12 + r, MINOR_INTERVALS] = 1.0
        loose[12 + r, TYPICAL_MINOR_INTERVALS] = 1.0
        prof[12 + r] = MINOR_PROFILE
    return np.asarray(cov), np.asarray(loose), np.asarray(prof)


_COV_MASK, _LOOSE_MASK, _PROFILES = _candidate_masks()

# rotation index table: rot[r, i] = (i + r%12) % 12 — candidate r compares the
# song's distribution re-rooted at tonic r (style/scales.py:211 rotates one
# semitone per yielded candidate).
_ROT_IDX = (np.arange(12)[None, :] + (np.arange(24)[:, None] % 12)) % 12


def scale_scores(keys_dist):
    """Vectorized 24-candidate scoring. Returns ``loss`` of shape (..., 24).

    ``keys_dist``: (..., 12) per-key total duration*velocity mass (normalized or
    not — it is renormalized here exactly like style/data.py:80-83 +
    style/utils/math.py). Scores in numpy float64.
    """
    keys_dist = np.asarray(keys_dist, dtype=np.float64)
    total = keys_dist.sum(axis=-1, keepdims=True)
    keys_dist = np.where(total > 0, keys_dist / np.where(total > 0, total, 1.0),
                         1.0 / keys_dist.shape[-1])

    rotated = keys_dist[..., _ROT_IDX]          # (..., 24, 12)
    cov_mask = np.asarray(_COV_MASK)
    loose_mask = np.asarray(_LOOSE_MASK)
    profiles = np.asarray(_PROFILES)

    coverage = (rotated * cov_mask).sum(-1)      # (..., 24)
    loose = (rotated * loose_mask).sum(-1)
    clipped = np.clip(rotated, _CE_EPS, 1.0)
    # parity: style/utils/metrics.py:4-8 — -sum(target*log(dist))/N with N=12
    ce = -(profiles * np.log(clipped)).sum(-1) / 12.0
    # parity: style/scales.py:188
    return ce * (1.5 - coverage) * (2.0 - loose)


def detect_scale(keys_dist) -> Scale:
    """Parity: style/scales.py:214-221 (get_scale) — argmin over the 24 losses."""
    loss = np.asarray(scale_scores(keys_dist))
    idx = int(loss.argmin())
    return Scale(tonic=idx % 12, is_minor=idx >= 12, loss=float(loss[idx]))


def score_scales(keys_dist):
    """All 24 candidate scores as records (parity: style/scales.py:160-190
    get_scales — same candidate order: 12 major keys C..B then 12 minor).
    The reference also computes an ndcg field through an unavailable import
    (scales.py:203, never used in the loss); it is omitted."""
    keys_dist = _normalize_dist(np.asarray(keys_dist, dtype=np.float64))
    rotated = keys_dist[_ROT_IDX]
    coverage = (rotated * _COV_MASK).sum(-1)
    loose = (rotated * _LOOSE_MASK).sum(-1)
    ce = -(_PROFILES * np.log(np.clip(rotated, _CE_EPS, 1.0))).sum(-1) / 12.0
    loss = ce * (1.5 - coverage) * (2.0 - loose)
    out = []
    for i in range(24):
        out.append({
            "key": KEY_NAMES[i % 12],
            "mode": "minor" if i >= 12 else "major",
            "coverage": float(coverage[i]),
            "loose_coverage": float(loose[i]),
            "cross_entropy": float(ce[i]),
            "loss": float(loss[i]),
        })
    return out


def detect_scales_batch(keys_dists):
    """Batched detection: (B, 12) -> (tonic (B,), is_minor (B,)) arrays.

    One vectorized scoring pass for a whole corpus (the reference detects one
    song at a time, style/scales.py:214)."""
    loss = scale_scores(keys_dists)
    idx = np.argmin(loss, axis=-1)
    return idx % 12, idx >= 12


def relative_degree(interval: int, source: Mode, target: Mode) -> float:
    """Parity: style/scales.py:100-104."""
    rel_shift = (source.shift - target.shift) % 7
    rel_interval = target.tonic_intervals[rel_shift]
    return target.degree_of(interval + rel_interval)


# --- chord naming (parity: style/scales.py:10-24, 75-83)

INTERVALS_TO_CHORD = {
    (0, 4, 7): "M",
    (0, 3, 7): "m",
    (0, 3, 6): "dim",
    (0, 4, 6): "♭5",
    (0, 4, 8): "aug",
    (0, 2, 6): "♭5/3",
}


def chord_name(chord) -> str:
    name = INTERVALS_TO_CHORD.get(tuple(chord))
    if name is None:
        raise ValueError(f"Unknown chord: {chord}")
    return name


def mode_chord(mode: Mode, degree0: int) -> str:
    """Triad quality on a scale degree (0-based) of a mode."""
    tonic = mode.tonic_intervals
    intervals = [tonic[(degree0 + j) % 7] + 12 * ((degree0 + j) // 7)
                 for j in (0, 2, 4)]
    root = intervals[0]
    return chord_name([(i - root) % 12 for i in intervals])


def mode_chords(mode: Mode):
    """All seven diatonic triads of a mode (parity: Mode.chords)."""
    return [mode_chord(mode, d) for d in range(7)]


def score_all_modes(keys_dist, modes=None, degrees=None):
    """Generic scorer over all 7 diatonic modes x 12 tonics (parity:
    style/scales.py:127-157 get_all_modes — present but unused by detection in
    the reference; loss = cross_entropy * (2 - coverage)). Returns a list of
    dicts ordered (tonic, mode).

    NOTE: the reference calls ``normalize_dist`` discarding its return value
    (scales.py:132,136,145 — no-ops on the local arrays); since this scorer is
    dead code there, the distributions are properly normalized here."""
    modes = modes or ALL_MODES
    degrees = [d - 1 for d in (degrees or range(1, 8))]
    keys_dist = _normalize_dist(np.asarray(keys_dist, dtype=np.float64))
    target = (MAJOR_PROFILE + MINOR_PROFILE) / 2  # target_mode_dist :117
    target_sel = target[degrees]
    target_sel = target_sel / target_sel.sum()

    results = []
    for tonic in range(12):
        for mode in modes:
            intervals = (np.asarray(mode.absolute_intervals) + tonic) % 12
            sample = keys_dist[intervals]
            coverage = sample.sum()
            sample_sel = sample[degrees]
            total = sample_sel.sum()
            sample_sel = (sample_sel / total if total > 0
                          else np.full_like(sample_sel,
                                            1.0 / len(sample_sel)))
            ce = -(target_sel * np.log(np.clip(sample_sel, _CE_EPS, 1.0))
                   ).sum() / len(sample_sel)
            results.append({
                "tonic": KEY_NAMES[tonic],
                "mode": mode,
                "coverage": float(coverage),
                "cross_entropy": float(ce),
                "loss": float(ce * (2.0 - coverage)),
            })
    return results


def keys_dist_from_notes(key_indices, weights):
    """Aggregate a (12,) key-mass distribution from note key indices and weights
    (duration*velocity). SoA replacement for style/midi_conversion.py:340-346 +
    style/data.py:79-84 (the tick2second factor is constant per song and cancels
    under normalization, so it is omitted)."""
    key_indices = np.asarray(key_indices)
    weights = np.asarray(weights)
    out = np.zeros(12, dtype=np.float64)
    np.add.at(out, key_indices % 12, weights)
    return out
