"""The 90th percentile of the wall time of every request of the window,
ms, each ending with its files written (``statistics.quantiles``, n=10).
What a transfer user waits for; the host's Python does most of it (the
device is idle 80-88% of a request), so it swings with the host's speed
from run to run. Layer: the entry, the request (``transfer``: ingest,
originals, the captured program, decode and writes). Moves
``gpu_ms_per_job``."""


def read(records):
    return records.get("request_p90_ms")
