"""Programs captured inside the window: the sum over the window's
micro-steps of the program's counter ``programs.captures``. Layer: the
programs (``runtime.programs``). Moves ``setup_s``."""

from benchmark.measure.spans import counted


def read(records):
    found = counted(records, "train.step", "programs.captures")
    return None if found is None else sum(found)
