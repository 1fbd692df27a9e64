"""Jobs whose files were written in the window, over the window's wall
seconds. What a GPU-hour buys with one client; host-bound like
``request_p90_ms.serve``. Layer: the entry, the request (``transfer``).
Moves ``gpu_ms_per_job``."""


def read(records):
    return records.get("jobs_per_s")
