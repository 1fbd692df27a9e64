"""Programs captured inside the window: the sum over the window's
requests of the program's counter ``programs.captures``; set-up should
have captured every program the window runs. Layer: the programs
(``runtime.programs``). Moves ``setup_s``."""

from benchmark.measure.spans import counted


def read(records):
    found = counted(records, "transfer.request", "programs.captures")
    return None if found is None else sum(found)
