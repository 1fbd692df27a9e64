"""Host wait for the next batch, ms per micro-step: the harness's own
span around each ``next()`` on the prefetch queue in the window, averaged.
Layer: data (``data.pipeline``, ``data.cache``, ``data.prefetch``,
``runtime.train.device_batch_from_songs``). Moves ``train_songs_per_s``."""


def read(records):
    return records.get("batch_wait_ms")
