"""K3 (``csrc/grid_tail_bwd.cu``) as a share of its roofline, %: the least
time of the traced micro-steps' K3 launches, each at its step's rows and
the cell's storage dtype (``measure.roofline.k3_work``), over the trace's
time of the K3 kernels. Where the tracer lost a K3 record, the least time
is scaled to the launches it kept. Layer: the kernels. Moves
``train_songs_per_s``."""

from benchmark.measure.roofline import k3_work, least_seconds


def read(records):
    trace = records.get("trace") or {}
    launches = (trace.get("records_by_category") or {}).get("K3", 0)
    rows = records.get("k3_rows") or []
    if not launches or not rows:
        return None
    storage = records.get("storage_dtype", "float32")
    bound = sum(least_seconds(*k3_work(n, storage)) for n in rows) * min(
        launches / len(rows), 1.0)
    return 100.0 * bound / trace["by_category_s"]["K3"]
