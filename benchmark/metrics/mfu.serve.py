"""The whole request's share of the card's dense peak, %: the matmul and
convolution FLOPs of one request, counted once by ``FlopCounterMode`` on
the plain reference's extraction and apply of a served request, over the
median request wall time of the window and the peak of the configuration's
compute dtype (67e12 fp32, 989e12 bf16). Layer: the whole request. Moves
``gpu_ms_per_job``."""

from benchmark.measure.roofline import PEAK_FLOPS


def read(records):
    flops = records.get("flops_per_request")
    if not flops:
        return None
    peak = PEAK_FLOPS[records["compute_dtype"]]
    return 100.0 * flops / records["request_median_s"] / peak
