"""The program's own spans and counters, as the per-layer metrics read
them: the units that ``mst_torch.runtime.profile`` keeps in memory.

The harness runs the readers in the process that ran the cell, after the
traffic driver returns. A reader takes the window's units: the last
``records["window_units"]`` units of its root span that began with no
profiler recording. The traffic drivers run set-up, then the window,
then the traced block (whose units are flagged as profiled), then the
comparison, which imports nothing of the port; so those units are the
window's. A
unit built ahead by the prefetch thread (``data.batch``) may fall just
before the window or after the traced block; its median moves by no
more than those few builds.

Where the program keeps no units (a program without the recorder), or
fewer than the window's, or the window's units hold none of the spans
read, a reader has nothing to read and returns None.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def window(records, root: str) -> Optional[List]:
    """The window's units of root span ``root``, oldest first, or None."""
    n = records.get("window_units")
    if not n:
        return None
    try:
        from mst_torch.runtime.profile import units
    except ImportError:
        return None
    kept = [u for u in units(root) if not u.profiled]
    if len(kept) < n:
        return None
    return kept[-n:]


def span_ms(records, root: str, names, how=statistics.median):
    """``how`` (median or mean) over the window's units of the self time
    of the spans ``names`` in each unit, summed, in ms; None where no unit
    holds any of them."""
    found = window(records, root)
    if found is None or not any(n in u.spans for u in found for n in names):
        return None
    return how([1e3 * sum(u.spans.get(n, 0.0) for n in names)
                for u in found])


def unit_ms(records, root: str):
    """The median duration of the window's units of ``root``, in ms."""
    found = window(records, root)
    if found is None:
        return None
    return statistics.median(1e3 * u.seconds for u in found)


def counted(records, root: str, name: str):
    """Counter ``name``, with its parts ``name.<part>``, in each of the
    window's units of ``root``: a list, or None."""
    found = window(records, root)
    if found is None:
        return None
    return [sum(v for k, v in u.counters.items()
                if k == name or k.startswith(name + "."))
            for u in found]
