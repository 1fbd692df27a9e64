"""Device busy time per micro-step, ms: the union of the device records'
intervals over the traced micro-steps, divided by their count. Layer: the
model step and the optimizer (``models``, ``ops``, ``runtime.train``).
Moves ``train_songs_per_s``."""


def read(records):
    trace = records.get("trace") or {}
    if not trace.get("device_records"):
        return None
    return 1e3 * trace["busy_s"] / trace["units"]
