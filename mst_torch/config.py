"""Typed configuration of the representation and the model (the port's
subset of mst_tpu/config.py; training, mesh and precision settings are not
ported yet, and the port computes in float32).

The reference scatters configuration over module-level constants
(train-model.py:33-60, style/model.py:11-28, style/midi_conversion.py:349-369,
style/data.py:19-31). Here everything lives in frozen dataclasses so configs are
hashable (usable as jit static args) and explicit.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RepresentationConfig:
    """Constants of the piano-roll representation.

    Parity: style/model.py:13-19 (n_beat_fractions=10, n_pitched_features=5,
    n_unpitched_features=2, n_octaves=8, n_scale_degrees=7, n_unpitched_notes=47)
    and style/midi_conversion.py:350-369 (beat_divisors=(8,3), percussion 35..81).
    """

    beat_divisors: Tuple[int, ...] = (8, 3)
    n_octaves: int = 8
    n_scale_degrees: int = 7
    min_percussion: int = 35
    max_percussion: int = 81
    n_pitched_features: int = 5   # duration, velocity, flat, natural, sharp
    n_unpitched_features: int = 2  # duration, velocity

    @property
    def beat_fractions(self) -> Tuple[Fraction, ...]:
        """Sorted distinct onset fractions within a beat (midi_conversion.py:358-362)."""
        return tuple(sorted({
            Fraction(i, d) for d in self.beat_divisors for i in range(d)
        }))

    @property
    def n_beat_fractions(self) -> int:
        return len(self.beat_fractions)

    @property
    def n_pitched_notes(self) -> int:
        return self.n_octaves * self.n_scale_degrees

    @property
    def n_unpitched_notes(self) -> int:
        return self.max_percussion - self.min_percussion + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (parity: train-model.py:54-60, style/model.py:20-27)."""

    beat_size: int = 64
    bar_size: int = 128
    n_rhythm_features: int = 8
    style_size: int = 256
    melody_size: int = 8
    rhythm_size: int = 32

    n_modes: int = 2
    min_bpm: float = 50.0
    max_bpm: float = 200.0
    mean_type: str = "quadratic"

    @property
    def bpm_range(self) -> float:
        return self.max_bpm - self.min_bpm
