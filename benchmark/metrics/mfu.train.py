"""The whole micro-step's share of the card's dense peak, %: forward and
backward matmul and convolution FLOPs of every micro-step of the window,
counted by ``FlopCounterMode`` on the plain reference at each step's
shapes, over the window and the peak of the configuration's compute dtype
(67e12 fp32, 989e12 bf16). Layer: the whole micro-step. Moves
``train_songs_per_s``."""

from benchmark.measure.roofline import PEAK_FLOPS


def read(records):
    flops = records.get("flops_window")
    if not flops:
        return None
    peak = PEAK_FLOPS[records["compute_dtype"]]
    return 100.0 * flops / records["window_s"] / peak
