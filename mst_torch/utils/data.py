"""Record/table helpers (behavioral spec: style/utils/data.py — dict rows to
DataFrames and to append-mode CSV files; consumed by corpus-stats-torch.py.
The training CSV log keeps its own writer, mst_torch.runtime.metrics).
``list2df`` needs pandas, imported when it is called."""

from __future__ import annotations

import csv
import os


def _iter_flat(d, path=()):
    for key, value in d.items():
        here = path + (str(key),)
        if isinstance(value, dict):
            yield from _iter_flat(value, here)
        else:
            yield "/".join(here), value


def flatten_dict(d) -> dict:
    """Flatten nested dicts into a single level with 'outer/inner' keys
    (insertion-ordered, like the flatten-dict package the reference pulled
    in via requirements.txt)."""
    return dict(_iter_flat(d))


def list2df(records, flatten=False, recursive=(), columns=(),
            include_all_columns=False):
    """Build a pandas DataFrame from dict records.

    ``flatten`` flattens nested dicts into 'a/b' columns; each column named
    in ``recursive`` holds lists of records and is itself converted to
    per-cell DataFrames; ``columns`` selects/orders the output columns
    (``include_all_columns`` appends the rest after them).
    Behavioral spec: utils/data.py:11-24."""
    import pandas as pd

    if flatten:
        records = [flatten_dict(r) for r in records]
    df = pd.DataFrame.from_records(records)
    for name in recursive:
        df[name] = [list2df(cell, flatten=flatten) for cell in df[name]]
    if columns:
        ordered = list(columns)
        if include_all_columns:
            ordered += [c for c in df.columns if c not in ordered]
        df = df[ordered]
    return df


_OPEN_MODES = {"append": "a", "overwrite": "w"}


def save_to_csv(path, data=(), fieldnames=None, when_exists="append", **row):
    """Write dict rows to a CSV file, emitting the header only when the file
    is (re)created. A single row can be given as keyword arguments, bulk rows
    via ``data``; ``fieldnames`` defaults to the first row's keys.
    Behavioral spec: utils/data.py:27-46."""
    if when_exists not in _OPEN_MODES:
        raise ValueError(f"Unknown option: {when_exists}")
    mode = _OPEN_MODES[when_exists]
    fresh = mode == "w" or not os.path.isfile(path)

    rows = ([row] if row else []) + list(data)
    if fieldnames is None:
        fieldnames = list(rows[0]) if rows else []

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, mode, encoding="utf-8", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames)
        if fresh:
            writer.writeheader()
        writer.writerows(rows)
