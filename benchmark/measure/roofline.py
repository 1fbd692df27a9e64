"""Peaks of the card and the work of the port's hand-written kernels.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): 67 TFLOP/s in fp32 outside the tensor cores, 989 TFLOP/s in bf16,
3.35 TB/s of HBM bandwidth.

A kernel's least time is the larger of its operations over the FLOP peak
and its bytes over the bandwidth, with each input byte read once and each
output byte written once, from the shapes of the call, as the kernel's
plain version defines the function. The note-grid tail (K2 forward, K3
backward) computes, for each row of ``n``,

    out[o, d, f] = sigmoid(sum_k LR(LR(xo[o, k]) + LR(xd[d, k])) w[k, f]
                           + rest[o, d, f]) * scale[f]

with O = 8 octaves, D = 7 degrees, K = 30 grid features, F = 5 outputs.
Its arithmetic runs in fp32 in both storage forms, so its FLOP peak is the
fp32 one.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
TAIL_FLOP_PEAK = PEAK_FLOPS["float32"]

O, D, K, F = 8, 7, 30, 5
# per (row, o, d, k): the sum and its LR, then a multiply and an add for
# each of F outputs
_FWD_FLOPS_PER_TERM = 2 + 2 * F
# the backward forms the grid again (2), the cotangent of each grid value
# over F (2F), its LR derivative (1), the sums over d and over o (2) and
# ct_w's product (2F)
_BWD_FLOPS_PER_TERM = 2 + 2 * F + 1 + 2 + 2 * F


def _size(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def k2_work(rows: int, rest_rows: int, storage: str = "float32"):
    """(FLOPs, bytes) of one K2 launch over ``rows`` rows whose ``rest``
    has ``rest_rows`` rows (it is read per song, not per channel). xo, xd
    and the output are at the storage dtype; w and rest are fp32."""
    s = _size(storage)
    flops = rows * O * D * K * _FWD_FLOPS_PER_TERM
    nbytes = (rows * (O * K + D * K) * s + K * F * 4
              + rest_rows * O * D * F * 4 + rows * O * D * F * s)
    return flops, nbytes


def k3_work(rows: int, storage: str = "float32"):
    """(FLOPs, bytes) of one K3 launch over ``rows`` rows: it reads xo, xd,
    the saved output and its cotangent (storage dtype) and w, and writes
    ct_xo, ct_xd (storage dtype), ct_y (fp32, every row) and ct_w."""
    s = _size(storage)
    flops = rows * O * D * K * _BWD_FLOPS_PER_TERM
    reads = rows * (O * K + D * K + 2 * O * D * F) * s + K * F * 4
    writes = rows * (O * K + D * K) * s + rows * O * D * F * 4 + K * F * 4
    return flops, reads + writes


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = TAIL_FLOP_PEAK) -> float:
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
