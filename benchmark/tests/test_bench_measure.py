"""The yardstick's arithmetic on known inputs."""

import pytest

from benchmark.measure import roofline
from benchmark.measure.trace import reduce_trace, union_seconds


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1, "pid": 1, "args": args}


FIXTURE = [
    _x("bench.requests", "user_annotation", -5, 80),
    _x("aten::copy_", "cpu_op", 20, 8),
    _x("cudaLaunchKernel", "cuda_runtime", 1, 1, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=2),
    _x("cudaMemcpyAsync", "cuda_runtime", 21, 1, correlation=3),
    _x("cudaGraphLaunch", "cuda_runtime", 36, 1, correlation=4),
    _x("cudaEventRecord", "cuda_runtime", 37, 1),
    _x("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel",
       0, 10, correlation=1),
    _x("void at::native::reduce_kernel<512>(int)", "kernel", 5, 10,
       correlation=2),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 30, 5,
       correlation=3),
    _x("grid_tail_kernel<0, false>", "kernel", 40, 20, correlation=4),
    _x("sm90_xmma_gemm_f32f32", "kernel", 200, 20, correlation=5),
]


def test_reduce_trace_numbers():
    r = reduce_trace(FIXTURE, -5, 75)
    assert r["device_records"] == 4           # the gemm lies outside
    assert r["busy_s"] == pytest.approx(40e-6)     # 0-15, 30-35, 40-60
    assert r["by_category_s"] == pytest.approx(
        {"elementwise/reduce": 20e-6, "copy": 5e-6, "K2": 20e-6})
    assert r["records_by_category"] == {"elementwise/reduce": 2, "copy": 1,
                                        "K2": 1}
    assert r["launch_calls"] == {"cudaLaunchKernel": 2, "cudaMemcpyAsync": 1,
                                 "cudaGraphLaunch": 1}
    # idle: -5..0, 15..30, 35..40, 60..75: 40 us, 7.5 of it under the copy
    assert sum(v for _, v in r["idle_gaps"]) == pytest.approx(40e-6)
    assert dict(r["idle_gaps"])["bench.requests > aten::copy_"] == \
        pytest.approx(15e-6)
    assert r["device_ops"][0][0] in ("vectorized_elementwise_kernel",
                                     "grid_tail_kernel")


def test_union_counts_overlap_once():
    assert union_seconds([(0, 10), (5, 15), (20, 21)]) == pytest.approx(
        16e-6)


@pytest.mark.parametrize("rows,rest,storage,ms", [
    (491520, 12 * 128 * 4 * 10, "float32", 0.4490),
    (491520, 12 * 128 * 4 * 10, "bfloat16", 0.2348),
])
def test_k2_bound_at_the_request_shape(rows, rest, storage, ms):
    """K2's least time at the 12-job request: bytes-bound, as the port's
    kernel table states it."""
    flops, nbytes = roofline.k2_work(rows, rest, storage)
    assert nbytes / roofline.HBM_BYTES_PER_S > flops / roofline.TAIL_FLOP_PEAK
    assert roofline.least_seconds(flops, nbytes) * 1e3 == pytest.approx(
        ms, rel=2e-3)


@pytest.mark.parametrize("rows,storage,ms", [
    (327680, "float32", 0.6808), (327680, "bfloat16", 0.3952),
    (122880, "bfloat16", 0.1482), (20480, "float32", 0.0425)])
def test_k3_bound_at_the_training_shapes(rows, storage, ms):
    flops, nbytes = roofline.k3_work(rows, storage)
    assert roofline.least_seconds(flops, nbytes) * 1e3 == pytest.approx(
        ms, rel=2e-3)


@pytest.mark.parametrize("kept", [6, 5])
def test_k3_reader_scales_to_the_records_kept(kept):
    """Six traced steps at 20,480 rows; a lost K3 record scales the bound
    with the kernel time that is left."""
    import os

    from benchmark import harness
    reader = harness.load_module(os.path.join(
        harness.HERE, "metrics", "k3_roofline.train.py"), "k3")
    one = roofline.least_seconds(*roofline.k3_work(20480))
    records = {"k3_rows": [20480] * 6, "storage_dtype": "float32",
               "trace": {"records_by_category": {"K3": kept},
                         "by_category_s": {"K3": kept * one * 2.0}}}
    assert reader.read(records) == pytest.approx(50.0)
