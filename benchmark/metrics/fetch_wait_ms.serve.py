"""Host time blocked on the program's buffer, ms a request: the mean over
the window's requests of the self time of the program's span ``5c fetch,
shard 0 (out of 5)``, every fetch of the request (a second program's
included). Layer: the programs (``runtime.programs``, the capacity ladder
and record pool of ``transfer.run_fused_jobs``). Moves
``gpu_ms_per_job``."""

import statistics

from benchmark.measure.spans import span_ms


def read(records):
    return span_ms(records, "transfer.request",
                   ("5c fetch, shard 0 (out of 5)",), how=statistics.mean)
