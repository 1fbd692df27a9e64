"""Instrument feature encoding (parity: style/data.py:19-31,122-127).

The reference fits two sklearn OneHotEncoders at import time over the 40
"popular" instruments and their 11 GM families. sklearn sorts categories
(numerically / lexicographically); we reproduce that ordering with plain numpy
so encodings are bit-identical without the sklearn dependency.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from benchmark.reference.mstref.io.midi import POPULAR_INSTRUMENTS, PROGRAM_TO_GROUP

INCLUDED_INSTRUMENTS = POPULAR_INSTRUMENTS
_INSTRUMENT_CATEGORIES = np.array(sorted(INCLUDED_INSTRUMENTS))
_GROUP_CATEGORIES = np.array(
    sorted({PROGRAM_TO_GROUP[p] for p in INCLUDED_INSTRUMENTS}))

N_INSTRUMENTS = len(INCLUDED_INSTRUMENTS) + 1  # +1: percussion (style/data.py:21)
PERCUSSION_ID = len(INCLUDED_INSTRUMENTS)      # style/data.py:31
INSTRUMENT_SIZE = len(_INSTRUMENT_CATEGORIES) + len(_GROUP_CATEGORIES)  # 51


def encode_instruments(instruments: Sequence[int]) -> np.ndarray:
    """(C,) program ids -> (C, 51) [instrument one-hot ++ group one-hot]."""
    instruments = np.asarray(instruments)
    inst_idx = np.searchsorted(_INSTRUMENT_CATEGORIES, instruments)
    if not np.all(_INSTRUMENT_CATEGORIES[np.clip(inst_idx, 0, 39)] == instruments):
        raise ValueError(f"unknown instrument ids in {instruments}")
    groups = np.array([PROGRAM_TO_GROUP[int(p)] for p in instruments])
    group_idx = np.searchsorted(_GROUP_CATEGORIES, groups)
    one_hot = np.zeros((len(instruments), INSTRUMENT_SIZE), dtype=np.float64)
    one_hot[np.arange(len(instruments)), inst_idx] = 1.0
    one_hot[np.arange(len(instruments)),
            len(_INSTRUMENT_CATEGORIES) + group_idx] = 1.0
    return one_hot


def decode_instruments(one_hot_rows: np.ndarray) -> List[int]:
    """Inverse of the instrument one-hot block (parity:
    instruments_one_hot_encoder.inverse_transform, style/style_transfer.py:115)."""
    idx = np.argmax(one_hot_rows[:, :len(_INSTRUMENT_CATEGORIES)], axis=1)
    return [int(_INSTRUMENT_CATEGORIES[i]) for i in idx]


def category_feature_table() -> np.ndarray:
    """(40, 51) float32: instrument features of each one-hot category index —
    lets the styled-instrument features be gathered on device from predicted
    category indices (no host round-trip)."""
    return encode_instruments(list(_INSTRUMENT_CATEGORIES)).astype(np.float32)


def instrument_category_index(program: int) -> int:
    """Position of a program id in the sorted instrument one-hot block."""
    idx = int(np.searchsorted(_INSTRUMENT_CATEGORIES, program))
    if idx >= len(_INSTRUMENT_CATEGORIES) or _INSTRUMENT_CATEGORIES[idx] != program:
        raise ValueError(f"unknown instrument id {program}")
    return idx


def category_instrument(index: int) -> int:
    """Program id at a position of the sorted instrument one-hot block."""
    return int(_INSTRUMENT_CATEGORIES[index])
