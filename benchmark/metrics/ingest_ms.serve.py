"""Host time of a request's ingest, ms: the median over the window's
requests of the self time of the program's span ``1 ingest
(read_midi+get_input)`` in its ``transfer.request`` unit (parse,
quantization and song assembly of every input file, threaded). Layer:
entry: the request (``transfer.transfer_styles``). Moves
``gpu_ms_per_job``."""

from benchmark.measure.spans import span_ms


def read(records):
    return span_ms(records, "transfer.request",
                   ("1 ingest (read_midi+get_input)",))
