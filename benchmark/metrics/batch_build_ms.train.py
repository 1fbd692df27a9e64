"""Time to build a batch, ms: the median duration of the program's
``data.batch`` units (``runtime.train.device_batch_from_songs`` on the
prefetch thread: labels, note records, K1's launch), as many as the
window's micro-steps. Layer: data (``data.pipeline``, ``data.cache``,
``data.prefetch``). Moves ``train_songs_per_s``."""

from benchmark.measure.spans import unit_ms


def read(records):
    return unit_ms(records, "data.batch")
