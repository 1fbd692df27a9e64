"""Small numpy helpers (parity: style/utils/numpy.py — both unused by the
reference's pipeline but part of its public utils surface)."""

from __future__ import annotations

import numpy as np


def to_1d_array(values) -> np.ndarray:
    """A 1-D object array holding arbitrary (possibly ragged) elements
    (parity: utils/numpy.py:4-8 — the object-array construction trick)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def as_1d_array(values) -> np.ndarray:
    """to_1d_array, passing through inputs that are already object arrays."""
    if isinstance(values, np.ndarray) and values.dtype == object \
            and values.ndim == 1:
        return values
    return to_1d_array(values)


def random_sample(values, n: int, rng=None, replace: bool = False):
    """Random subset of a sequence (parity: utils/numpy.py:14-23)."""
    rng = rng or np.random.default_rng()
    idx = rng.choice(len(values), size=min(n, len(values)), replace=replace)
    return [values[i] for i in idx]
