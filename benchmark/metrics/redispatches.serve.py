"""Programs run again a request: the mean over the window's requests of
the program's counter ``transfer.redispatch`` (all its reasons:
``capacity``, ``pool``, ``dense``). Layer: the programs
(``runtime.programs``, the capacity ladder and record pool). Moves
``gpu_ms_per_job``."""

import statistics

from benchmark.measure.spans import counted


def read(records):
    found = counted(records, "transfer.request", "transfer.redispatch")
    return None if found is None else statistics.mean(found)
