"""Share of the window in which the device is idle, %: 100 - the device busy
time per micro-step (the union of the device records of the
``trace_steps`` micro-steps traced after the window) over the window's
wall time per micro-step. The traced stretch itself runs slower than the
window (the profiler costs host time at each launch), so its own busy
share would overstate the idle one. Layer: the device. Moves
``train_songs_per_s``."""


def read(records):
    trace = records.get("trace") or {}
    if not trace.get("device_records"):
        return None
    busy = trace["busy_s"] / trace["units"]
    wall = records["window_s"] / records["window_units"]
    return 100.0 * (1.0 - busy / wall)
