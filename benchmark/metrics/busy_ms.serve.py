"""Device busy time per request, ms: the union of the device records'
intervals over the traced requests, divided by their count. Layer: the
model step on the device (``models``, ``ops``, the captured programs).
Moves ``gpu_ms_per_job``."""


def read(records):
    trace = records.get("trace") or {}
    if not trace.get("device_records"):
        return None
    return 1e3 * trace["busy_s"] / trace["units"]
