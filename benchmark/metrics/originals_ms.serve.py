"""Host time of a request's originals, ms: the median over the window's
requests of the self time of the program's span ``4 originals
decode+write`` (``transfer.write_originals``, run while the request's
program runs on the card). Layer: entry: the request. Moves
``gpu_ms_per_job``."""

from benchmark.measure.spans import span_ms


def read(records):
    return span_ms(records, "transfer.request",
                   ("4 originals decode+write",))
