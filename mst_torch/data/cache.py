"""Cross-epoch ingestion cache: ingest each corpus file once, replay from RAM.

A copy of mst_tpu/data/cache.py (framework-free) for the port's trainer.

The reference re-opens, re-parses and re-rasterizes every MIDI file on every
epoch (style/data.py:34-48 — ``iter_all_midis`` loops over the same paths and
calls ``load_midi_from_file`` each time; ``train-model.py:92-93`` hides some
of that behind one prefetch thread but pays all of it every epoch). On the
device-raster training path the host never needs the dense raster
at all, so one song's replayable state is just its SoA note arrays + metadata
(~tens of KB) — cheap enough to keep thousands of songs resident and make
every epoch after the first cost ~zero host CPU.

Design:

- Byte-bounded LRU keyed by file path, storing :meth:`Song.slim` copies
  (dense rasters dropped; they rebuild lazily if a consumer ever asks).
- Known-bad verdicts (unloadable / malformed / no modeled pitched channel)
  are cached too, so bad files stop costing a parse attempt each epoch.
- Replay is by ``dataclasses.replace(song, cursor=...)`` in
  :func:`mst_torch.data.pipeline.iter_inputs` — the yielded stream is
  byte-for-byte the order/cursor stream of an uncached run.
- NOT thread-safe: the single prefetch thread is the only consumer.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

_BAD_COST = 64  # nominal accounting bytes for a known-bad path entry


def _stat_sig(path: str):
    """(st_mtime_ns, st_size) freshness signature, or None if unstattable."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


class SongCache:
    """Byte-bounded LRU of slim Songs (and known-bad paths).

    Entries carry the file's (mtime_ns, size) at ingestion time; a mismatch
    on :meth:`get` (e.g. the corpus file was regenerated mid-run) drops the
    entry and reports a miss, so stale parses are re-ingested instead of
    replayed silently for every remaining epoch.
    """

    BAD = object()  # sentinel: path is known unloadable/filtered

    def __init__(self, max_bytes: int = 512 << 20):
        self.max_bytes = int(max_bytes)
        # path -> (stat_sig, payload, cost)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, path: str):
        """The cached slim Song, ``SongCache.BAD``, or None (miss)."""
        entry = self._entries.get(path)
        if entry is None:
            self.misses += 1
            return None
        sig, payload, cost = entry
        # sig is None when the file was unstattable at insert time (a BAD
        # verdict for a then-missing file): _stat_sig(path) is None again
        # while it stays missing, and becomes a mismatch the moment the file
        # appears — so a corpus file created after a failed load re-parses
        if _stat_sig(path) != sig:
            # file changed on disk since ingestion: stale — drop and re-parse
            del self._entries[path]
            self._bytes -= cost
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(path)
        return payload

    def put(self, path: str, song) -> None:
        """Cache one slim Song (callers pass ``song.slim()``)."""
        self._insert(path, song, song.nbytes)

    def put_bad(self, path: str) -> None:
        self._insert(path, self.BAD, _BAD_COST)

    def _insert(self, path: str, payload, cost: int) -> None:
        if cost > self.max_bytes:
            return  # a single over-budget song would evict everything
        old = self._entries.pop(path, None)
        if old is not None:
            self._bytes -= old[2]
        self._entries[path] = (_stat_sig(path), payload, cost)
        self._bytes += cost
        while self._bytes > self.max_bytes and self._entries:
            _, (_, _, evicted_cost) = self._entries.popitem(last=False)
            self._bytes -= evicted_cost

    def stats(self) -> dict:
        return {"songs": len(self._entries), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses}
