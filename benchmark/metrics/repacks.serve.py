"""Record-pool re-packs a request: the mean over the window's requests of
the program's counter ``transfer.repack``, the records of a run packed
again at the exact pool tier instead of a second run of the program.
Layer: the programs (``runtime.programs``, the capacity ladder and record
pool). Moves ``gpu_ms_per_job``.

A request through the record pool holds the counter even at 0; where no
request of the window holds it, the program has no re-pack, and there is
nothing to read."""

import statistics

from benchmark.measure.spans import window

COUNTER = "transfer.repack"


def read(records):
    found = window(records, "transfer.request")
    if found is None or not any(COUNTER in u.counters for u in found):
        return None
    return statistics.mean(u.counters.get(COUNTER, 0) for u in found)
