"""Host time of a request's styled outputs, ms: the median over the
window's requests of the self times of the program's spans ``6 styled
decode+write`` and ``6a packed-job decode (out of 6)`` together (each
job's records decoded to MIDI and written). Layer: entry: the request.
Moves ``gpu_ms_per_job``."""

from benchmark.measure.spans import span_ms


def read(records):
    return span_ms(records, "transfer.request",
                   ("6 styled decode+write",
                    "6a packed-job decode (out of 6)"))
