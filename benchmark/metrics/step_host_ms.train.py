"""Host time of a micro-step's call, ms: the median duration of the
program's ``train.step`` units in the window (the schedule, the input
loads, the replay's launch and the outputs' clone; the card's work is
queued, not waited for). Layer: the programs (``runtime.programs``,
``runtime.train``). Moves ``train_songs_per_s``."""

from benchmark.measure.spans import unit_ms


def read(records):
    return unit_ms(records, "train.step")
