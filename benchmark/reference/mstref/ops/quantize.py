"""Onset-grid quantization, vectorized over whole note arrays.

Parity target: style/midi_conversion.py:425-456 (kchannel2qchannel) +
style/utils/math.py:14-19 (round_number: round to a multiple, exact halves round
up). The reference quantizes one note at a time in Python; here the min-error
choice between the 1/8 and 1/3 beat grids is a few float64 array ops, run on the
host.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np


def round_to_multiple(number, precision, xp=np):
    """Vectorized round_number (style/utils/math.py:14-19).

    Returns (rounded, signed_error) with ``rounded = number - error``; halves
    round *up* (the reference's ``remainder_pos < remainder_neg`` comparison).
    Float64 arithmetic matches the reference's Python-float behavior bit for bit.
    """
    number = xp.asarray(number, dtype=xp.float64)
    remainder_pos = number % precision
    remainder_neg = xp.abs(remainder_pos - precision)
    down = remainder_pos < remainder_neg
    rounded = xp.where(down, number - remainder_pos, number + remainder_neg)
    error = xp.where(down, remainder_pos, -remainder_neg)
    return rounded, error


@dataclasses.dataclass(frozen=True)
class FractionGrid:
    """Precomputed structures for a set of beat divisors.

    ``frac_index[d][q]`` maps (divisor d, quant q) to the index of q/d in the
    sorted distinct fraction list (parity: midi_conversion.py:358-364).
    ``frac_ticks(tpb)`` gives onset tick offsets per fraction index
    (``int(Fraction * tpb)`` — exact rational floor, midi_conversion.py:459-463).
    """

    divisors: Tuple[int, ...]
    fractions: Tuple[Fraction, ...]

    @classmethod
    def create(cls, divisors: Sequence[int]) -> "FractionGrid":
        fractions = tuple(sorted({
            Fraction(i, d) for d in divisors for i in range(d)
        }))
        return cls(divisors=tuple(divisors), fractions=fractions)

    @property
    def n_fractions(self) -> int:
        return len(self.fractions)

    def frac_index_table(self) -> dict:
        lookup = {f: i for i, f in enumerate(self.fractions)}
        return {d: np.array([lookup[Fraction(i, d)] for i in range(d)],
                            dtype=np.int32)
                for d in self.divisors}

    def frac_ticks(self, ticks_per_beat: int) -> np.ndarray:
        return np.array([(f.numerator * ticks_per_beat) // f.denominator
                         for f in self.fractions], dtype=np.int64)


def quantize_onsets(times: np.ndarray, ticks_per_beat: int, ticks_per_bar: int,
                    grid: FractionGrid, xp=np):
    """Quantize onset times to the nearest point of any divisor grid.

    Returns (qtime int64, bar int64, beat int64, frac_idx int32). The divisor
    with the smallest |error| wins; earlier divisors win ties (the reference's
    ``min`` over a generator keeps the first minimum, midi_conversion.py:446).
    """
    times = xp.asarray(times)
    best_err = None
    best_q = None
    best_div_pos = None
    for pos, divisor in enumerate(grid.divisors):
        precision = ticks_per_beat / divisor  # float, parity :432
        q, err = round_to_multiple(times, precision, xp=xp)
        abs_err = xp.abs(err)
        if best_err is None:
            best_err, best_q = abs_err, q
            best_div_pos = xp.zeros(times.shape, dtype=xp.int32)
        else:
            better = abs_err < best_err
            best_q = xp.where(better, q, best_q)
            best_err = xp.where(better, abs_err, best_err)
            best_div_pos = xp.where(better, pos, best_div_pos)

    qtime = best_q.astype(xp.int64)  # int() truncation, parity :447
    bar = qtime // ticks_per_bar
    rem = qtime - bar * ticks_per_bar
    beat = rem // ticks_per_beat
    ticks = rem - beat * ticks_per_beat

    # quants = int(ticks // (tpb / divisor)) with float division, parity :451
    frac_idx = xp.zeros(times.shape, dtype=xp.int32)
    index_tables = grid.frac_index_table()
    for pos, divisor in enumerate(grid.divisors):
        precision = ticks_per_beat / divisor
        quants = (ticks.astype(xp.float64) // precision).astype(xp.int64)
        quants = xp.clip(quants, 0, divisor - 1)
        table = xp.asarray(index_tables[divisor])
        frac_idx = xp.where(best_div_pos == pos, table[quants], frac_idx)
    return qtime, bar, beat, frac_idx
