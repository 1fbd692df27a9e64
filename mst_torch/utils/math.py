"""Scalar/array math helpers (parity: style/utils/math.py).

The vectorized versions used on the hot paths are
mst_torch.theory.scales._normalize_dist and mst_torch.ops.quantize.round_to_multiple;
these are the general-purpose equivalents.
"""

from __future__ import annotations

import numpy as np


def normalize_dist(dist):
    """Normalize to a probability vector; uniform fallback on zero total
    (parity: utils/math.py:4-11)."""
    dist = np.array(dist, dtype=np.float64)
    assert len(dist)
    total = dist.sum()
    if total > 0:
        return dist / total
    return np.full_like(dist, 1.0 / len(dist))


def round_number(number, precision=1):
    """Round ``number`` to the nearest multiple of ``precision``.

    Returns ``(rounded, error)`` with ``error == number - rounded`` (so the
    error is positive when rounding down); exact halves round to the larger
    multiple (behavioral spec: utils/math.py:14-19; the vectorized hot-path
    twin is mst_torch.ops.quantize.round_to_multiple)."""
    offset = number % precision
    if 2 * offset >= precision:  # at or past the midpoint: round up
        rounded = number + (precision - offset)
    else:
        rounded = number - offset
    return rounded, number - rounded
