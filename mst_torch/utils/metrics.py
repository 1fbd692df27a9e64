"""Distribution metrics (parity: style/utils/metrics.py)."""

from __future__ import annotations

import numpy as np


def cross_entropy(dist, target_dist, epsilon=1e-12):
    """-sum(target * log(clip(dist))) / N (parity: utils/metrics.py:4-8)."""
    dist = np.clip(dist, epsilon, 1.0)
    return -np.sum(target_dist * np.log(dist)) / dist.shape[0]
