"""Generic utilities (parity: style/utils/__init__.py + style/utils/misc.py).

The shape/tensor helpers of the reference's utils live in mst_torch.ops.shapes
(squash_dims, cat_with_broadcast), mst_torch.ops.lstm (LSTM / the Distributed
pattern) and mst_torch.ops.losses (get_mean); the progress/CSV machinery in
mst_torch.runtime.metrics; the prefetcher in mst_torch.data.prefetch. This module
keeps the remaining small generic helpers.
"""

from __future__ import annotations

import glob
import operator
import os


def freeze(obj):
    """Recursively hashable view of a value: lists/tuples become tuples of
    frozen elements, sets become frozensets (behavioral spec:
    utils/__init__.py:5-10 — used so container-valued group keys can be
    dict keys)."""
    if isinstance(obj, set):
        return frozenset(freeze(v) for v in obj)
    if isinstance(obj, (list, tuple)):
        return tuple(freeze(v) for v in obj)
    return obj


def _key_getter(key, attr):
    """Resolve group_by's key spec to a callable (or None for identity)."""
    if callable(key):
        return key
    if key is not None:
        return operator.itemgetter(key)
    if attr is not None:
        return operator.attrgetter(attr)
    return None


def group_by(data, key=None, attr=None, func=None, save_indices=False):
    """Group ``data`` into an insertion-ordered ``{key: [items]}`` dict.

    ``key`` may be a callable, a mapping key, or (via ``attr``) an attribute
    name; with neither, items group by their own value. ``save_indices``
    collects positions instead of items; ``func`` aggregates each group
    (behavioral spec: utils/__init__.py:13-33)."""
    getter = _key_getter(key, attr)
    groups: dict = {}
    for index, item in enumerate(data):
        k = item if getter is None else freeze(getter(item))
        groups.setdefault(k, []).append(index if save_indices else item)
    if func is not None:
        return {k: func(members) for k, members in groups.items()}
    return groups


def flatten(items):
    """Concatenate one level of nesting into a list
    (behavioral spec: utils/__init__.py:36-37)."""
    return [x for sub in items for x in sub]


def dict_map(func, d, recursive=False):
    """Parity: utils/misc.py:120-125."""
    if not recursive:
        return {k: func(v) for k, v in d.items()}
    if isinstance(d, dict):
        return {k: dict_map(func, v, recursive) for k, v in d.items()}
    return func(d)


def iter_all_files(path, pattern="**/*"):
    """Parity: utils/misc.py:10-14."""
    full = os.path.join(path, pattern)
    yield from (x for x in glob.iglob(full, recursive=True)
                if os.path.isfile(x))


def make_dirs(path):
    os.makedirs(path or ".", exist_ok=True)


def assert_dir(path):
    make_dirs(os.path.dirname(path))
