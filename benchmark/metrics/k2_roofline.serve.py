"""K2 (``csrc/grid_tail.cu``) as a share of its roofline, %: the least
time of its launches at the request's shape (``measure.roofline.k2_work``:
each input byte read once, each output byte written once, at 3.35 TB/s,
and its operations at 67 TFLOP/s) over the trace's time of the K2
kernels. Layer: the kernels. Moves ``gpu_ms_per_job``."""

from benchmark.measure.roofline import k2_work, least_seconds


def read(records):
    trace = records.get("trace") or {}
    launches = (trace.get("records_by_category") or {}).get("K2", 0)
    if not launches:
        return None
    flops, nbytes = k2_work(records["k2_rows"], records["k2_rest_rows"],
                            records.get("storage_dtype", "float32"))
    bound = least_seconds(flops, nbytes) * launches
    return 100.0 * bound / trace["by_category_s"]["K2"]
