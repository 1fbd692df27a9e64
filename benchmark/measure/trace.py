"""The benchmark's reading of a ``torch.profiler`` Chrome trace.

A frozen copy of the arithmetic of the port's ``runtime.profile.summarize``
(device records are kernels, copies and memsets; a kernel's category comes
from its name: K1, K2, K3 by symbol, copies, matmuls and convolutions by
library name, the rest elementwise/reduce; an idle gap is named by the host
ranges open across its middle), with two changes: busy time is the union
of the device records' intervals, so work that overlaps on two streams is
counted once, and every number is in seconds over the traced window. A
replayed CUDA graph carries no host op per kernel, so no category here
comes from the launching op.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host calls that hand work to the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaLaunchCooperativeKernel",
                "cudaLaunchKernelExC", "cuLaunchKernelEx", "cudaMemcpyAsync",
                "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD8Async",
                "cuMemsetD32Async", "cudaMemcpy", "cudaMemset")
KERNEL_SYMBOLS = (("K3", "grid_tail_bwd_kernel"), ("K2", "grid_tail_kernel"),
                  ("K1", "raster_kernel"))
TOP = 10


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)["traceEvents"]


def kernel_category(name: str, cat: str) -> str:
    for label, symbol in KERNEL_SYMBOLS:
        if symbol in name:
            return label
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    low = name.lower()
    if "cudnn" in low or "conv" in low:
        return "conv"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "cublas", "sm90_")):
        return "matmul"
    return "elementwise/reduce"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    head = "".join(out).split("(")[0].strip()
    return (head.split(" ")[-1] if "::" in head else head)[:120]


class _Thread:
    """One host thread's ranges; ``stack_at(ts)`` gives the ranges open at
    ``ts``, outermost first."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.ranges]
        self.parent = []
        open_ = []
        for i, e in enumerate(self.ranges):
            while open_ and _end(self.ranges[open_[-1]]) <= e["ts"]:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def stack_at(self, ts: float) -> List[dict]:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and _end(self.ranges[i]) < ts:
            i = self.parent[i]
        stack = []
        while i >= 0:
            stack.append(self.ranges[i])
            i = self.parent[i]
        return stack[::-1]


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


def union_seconds(intervals) -> float:
    """Seconds covered by ``(start_us, end_us)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def reduce_trace(events: List[dict], t0_us: float = None,
                 t1_us: float = None) -> Dict:
    """The numbers of a traced window (``t0_us``..``t1_us``, the harness's
    own range around the traced work; default the device records' span):
    device busy seconds (union), device seconds by category and by kernel,
    device record counts, host launch calls by name, and the idle seconds
    by what the host was doing."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    if t0_us is not None:
        device = [e for e in device if e["ts"] >= t0_us and _end(e) <= t1_us]
    if not device:
        return {"device_records": 0}
    by_tid = collections.defaultdict(list)
    launches = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in RANGE_CATS and not e["name"].startswith("ProfilerStep#"):
            by_tid[e["tid"]].append(e)
        elif cat in LAUNCH_CATS and e["name"] in LAUNCH_CALLS:
            if t0_us is None or t0_us <= e["ts"] <= t1_us:
                launches[e["name"]] += 1
    threads = {tid: _Thread(r) for tid, r in by_tid.items()}
    busiest = sorted(threads, key=lambda t: -len(threads[t].ranges))
    by_cat = collections.defaultdict(float)
    by_kernel = collections.defaultdict(float)
    count_cat = collections.Counter()
    for e in device:
        cat = kernel_category(e["name"], e.get("cat"))
        by_cat[cat] += e["dur"] / 1e6
        count_cat[cat] += 1
        by_kernel[short_name(e["name"])] += e["dur"] / 1e6
    intervals = sorted((e["ts"], _end(e)) for e in device)
    start = intervals[0][0] if t0_us is None else t0_us
    stop = max(e for _, e in intervals) if t1_us is None else t1_us
    gaps = []
    busy_to = start
    for s, e in intervals + [(stop, stop)]:
        if s > busy_to:
            gaps.append((s - busy_to, busy_to))
        busy_to = max(busy_to, e)
    gaps.sort(key=lambda g: -g[0])

    def host_at(ts):
        for tid in busiest:
            stack = threads[tid].stack_at(ts)
            if stack:
                return " > ".join(x["name"] for x in stack[-3:])
        return "(no op: Python or idle)"

    idle = collections.defaultdict(float)
    for gap, at in gaps:
        idle[host_at(at + gap / 2)] += gap / 1e6
    return {
        "device_records": len(device),
        "busy_s": union_seconds(intervals),
        "by_category_s": dict(by_cat),
        "records_by_category": dict(count_cat),
        "device_ops": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
        "launch_calls": dict(launches),
    }
