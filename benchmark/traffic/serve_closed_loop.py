"""Traffic driver: one client sends transfer requests back to back.

Each request is ``mst_torch.transfer.transfer_styles(bundle, compositions,
styles, out_dir)`` on one ``ModelBundle`` with its defaults (captured
programs, the record pool, the capacity ladder), and ends when its files
are written. The mix's parameters (``traffic/<mix>.json``):

- ``compositions``, ``styles``: songs of each kind in a request;
- ``pool``: songs of each kind, generated in set-up with the generator's
  overrides ``sizes`` (beats per bar, bars, pitched channels,
  percussion), from ``pool_seeds[0]`` (compositions) and
  ``pool_seeds[1]`` (styles);
- ``requests``: the distinct requests, drawn from the pool with
  ``pool_seeds[2]``; ``key``: the extraction shapes every one of them
  takes (bar bucket, pitched and unpitched note-record buckets): a drawn
  request with other shapes is drawn again.

The songs, the requests and their cycle are the same in every run; the
seed picks where in the cycle the window starts, and which served
requests are compared. How many notes the model writes for a request,
and so its work, depends on the music, and the record-pool tier a
request runs at follows the request before it (the bundle's sticky
sizing: a second dispatch when the tier is too small, a larger pool and
fetch when it is too large). A cycle whose order moved with the seed
changed the work by 15-20% (measured on one H100); a rotation keeps every
transition. Set-up sends ``warmup_cycles[0]`` whole cycles from the same
start (up to ``warmup_cycles[1]``, until a cycle captures no new
program), so the window replays programs that set-up captured, every
record-pool tier its cycle reaches included.

- ``sample``: served requests compared with the reference after the
  window, drawn by the seed; ``trace_cycles``: whole cycles of requests
  traced after the window, on the card, in every run. Their device busy
  time per job is the end-to-end ``gpu_ms_per_job``, and the per-layer
  metrics read the same trace. A whole cycle holds every request and
  every transition between requests once, so the traced work is the same
  for every seed.

Each request writes into a directory of its own under the run's scratch
directory; the files stay until the comparison has read them.
"""

from __future__ import annotations

import gc
import os
import statistics
import time

import numpy as np


def _pool(ctx, kind_seed: int, n: int, sizes):
    from benchmark.gen import songs
    spec = [dict(numer=s[0], n_bars=s[1], n_pitched=s[2], drums=bool(s[3]))
            for s in sizes]
    rng = np.random.default_rng(kind_seed)
    order = rng.permutation(n)            # which song gets which size
    data, _ = songs.make_pool(kind_seed, n, sizes=[spec[i] for i in order])
    return data


def _write(directory, names, blobs):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, blob in zip(names, blobs):
        path = os.path.join(directory, f"{name}.mid")
        with open(path, "wb") as fh:
            fh.write(blob)
        paths.append(path)
    return paths


def plan_requests(ctx, comp_songs, style_songs, n: int):
    """The mix's ``n`` distinct requests (composition indices, style
    indices), each of whose songs take the mix's extraction shapes."""
    from benchmark.reference.serve_ref import host_key

    mix = ctx.cell.mix
    want = tuple(mix["key"])
    rng = np.random.default_rng(mix["pool_seeds"][2])
    out = []
    for _ in range(100 * n):
        c = sorted(rng.choice(len(comp_songs), mix["compositions"],
                              replace=False).tolist())
        s = sorted(rng.choice(len(style_songs), mix["styles"],
                              replace=False).tolist())
        key = host_key([comp_songs[i] for i in c] + [style_songs[i] for i in s])
        if key[3:] == want and (c, s) not in out:
            out.append((c, s))
            if len(out) == n:
                return out
    raise RuntimeError(f"the pool gives too few requests of key {want}")


def run(ctx, device: str = "cuda", breaker=None):
    import torch

    from benchmark.reference import serve_ref
    from mst_torch.config import ModelConfig
    from mst_torch.transfer import ModelBundle, transfer_styles

    mix, cfg = ctx.cell.mix, ctx.cell.config
    on_card = device != "cpu"
    comp_data = _pool(ctx, mix["pool_seeds"][0], mix["pool"], mix["sizes"])
    style_data = _pool(ctx, mix["pool_seeds"][1], mix["pool"], mix["sizes"])
    comp_names = [f"comp_{i}" for i in range(len(comp_data))]
    style_names = [f"style_{i}" for i in range(len(style_data))]
    inputs = os.path.join(ctx.scratch, "inputs")
    comp_paths = _write(inputs, comp_names, comp_data)
    style_paths = _write(inputs, style_names, style_data)
    comp_songs = [serve_ref.ingest(b) for b in comp_data]
    style_songs = [serve_ref.ingest(b) for b in style_data]
    requests = plan_requests(ctx, comp_songs, style_songs, mix["requests"])
    start = int(np.random.default_rng([ctx.seed, 2]).integers(len(requests)))
    order = [(start + k) % len(requests) for k in range(len(requests))]

    config = ModelConfig(**cfg["model"])
    weights = ctx.path(cfg["weights"]["serve"])
    bundle = ModelBundle.from_npz(weights, device=device, config=config,
                                  capture=on_card)
    if breaker is not None:
        breaker(bundle)

    def send(i, root):
        c, s = requests[order[i % len(requests)]]
        out_dir = os.path.join(ctx.scratch, root, f"r{i}")
        transfer_styles(bundle, [comp_paths[k] for k in c],
                        [style_paths[k] for k in s], out_dir)
        return out_dir

    def graphs():
        return len(bundle.programs.graphs)

    def keys():
        return sorted({k[0] for k in bundle.programs.graphs})

    # warm up: whole cycles of the window's requests, in its order
    t_warm = time.perf_counter()
    c_min, c_max = mix["warmup_cycles"]
    for cycle in range(c_max):
        before = graphs()
        for k in range(len(requests)):
            send(k, "warmup")
        if cycle + 1 >= c_min and graphs() == before:
            break
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.note(f"warm-up: {cycle + 1} cycles of {len(requests)} requests in "
             f"{time.perf_counter() - t_warm:.3f} s; programs {keys()}")

    # the measured window
    latencies, dirs, failed = [], [], 0
    captured = graphs()
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        try:
            dirs.append(send(i, "window"))
            latencies.append(time.perf_counter() - start)
        except Exception as exc:      # a failed request is counted
            failed += 1
            dirs.append(None)
            latencies.append(float("inf"))
            ctx.note(f"request {i} failed: {exc!r}")
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    new_graphs = graphs() - captured
    if new_graphs:
        ctx.note(f"{new_graphs} program(s) captured inside the window; "
                 f"programs {keys()}")
    jobs = mix["compositions"] * (1 + mix["styles"])
    done = sum(1 for d in dirs if d is not None)
    by_request = {}
    for j, x in enumerate(latencies):
        by_request.setdefault(int(order[j % len(requests)]), []).append(x)
    ms = sorted(x * 1e3 for x in latencies)
    ctx.note(f"latency ms: min {ms[0]:.1f}, median "
             f"{statistics.median(ms):.1f}, max {ms[-1]:.1f}; median by "
             "request " + ", ".join(
                 f"{k}: {statistics.median(v) * 1e3:.1f}"
                 for k, v in sorted(by_request.items())))
    memory_peak = (torch.cuda.max_memory_allocated() if on_card else 0)

    records = {"request_median_s": statistics.median(latencies),
               "window_s": window, "window_units": len(dirs),
               "compute_dtype": config.compute_dtype}
    records["request_p90_ms"] = (statistics.quantiles(ms, n=10)[-1]
                                 if len(ms) > 1 else ms[0])
    records["jobs_per_s"] = jobs * done / window
    gpu_ms_per_job = None
    if on_card:
        from benchmark.harness import traced
        n = mix["trace_cycles"] * len(requests)
        t_trace = time.perf_counter()
        with traced(ctx, "requests") as trace:
            for k in range(n):
                send(i + k, "traced")
        trace["units"] = n
        records["trace"] = trace
        if trace.get("device_records"):
            gpu_ms_per_job = 1e3 * trace["busy_s"] / (n * jobs)
        ctx.note(f"traced {n} requests ({trace.get('device_records', 0)} "
                 f"device records) in {time.perf_counter() - t_trace:.3f} "
                 f"s; gpu_ms_per_job {gpu_ms_per_job}")
        c, s = requests[order[0]]
        Rs = serve_ref.host_key([comp_songs[k] for k in c]
                                + [style_songs[k] for k in s])
        records["k2_rows"] = jobs * Rs[2] * Rs[3] * Rs[0] * 10
        records["k2_rest_rows"] = jobs * Rs[3] * Rs[0] * 10

    # the comparison, once the program's state is freed
    rng = np.random.default_rng([ctx.seed, 3])
    served = [k for k, d in enumerate(dirs) if d is not None]
    sample = sorted(rng.choice(served, min(mix["sample"], len(served)),
                               replace=False).tolist()) if served else []
    del bundle
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = serve_ref.Reference(weights, device,
                              serve_ref.ModelConfig(**cfg["model"]))
    gap, differ, files = 0.0, 0, 0
    flops = None
    t_ref = time.perf_counter()
    for k in sample:
        c, s = requests[order[k % len(requests)]]
        v = serve_ref.judge_request(
            ref, [comp_data[j] for j in c], [style_data[j] for j in s],
            [comp_names[j] for j in c], [style_names[j] for j in s],
            dirs[k], count_flops=flops is None)
        if flops is None:
            flops = v.flops
        gap = max(gap, v.note_gap)
        differ += v.originals_differ
        files += v.files
    ctx.note(f"compared {len(sample)} requests ({files} files) in "
             f"{time.perf_counter() - t_ref:.3f} s; window {window:.3f} s, "
             f"{len(dirs)} requests, set-up {setup_s:.3f} s")
    records["flops_per_request"] = flops
    ctx.note(f"request_p90_ms {records['request_p90_ms']!r}, jobs_per_s "
             f"{records['jobs_per_s']!r}")
    checks = ctx.cell.workload["check"]
    return {
        "correct": failed == 0 and bool(sample),
        "attempted": len(dirs),
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "end_to_end": {
            "setup_s": setup_s,
            "gpu_ms_per_job": gpu_ms_per_job,
        },
        "checks": {
            "note_gap": {"value": gap, "limit": checks["note_gap"]},
            "originals_differ": {"value": differ,
                                 "limit": checks["originals_differ"]},
        },
        "records": records,
    }
