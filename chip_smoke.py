#!/usr/bin/env python3
"""Drive the PyTorch port (``mst_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. The card's name and power limit (``nvidia-smi``), the torch and CUDA
   versions, the TF32 flags, the MIDI codec in use, and the build of every
   CUDA kernel of the main path from ``mst_torch/csrc`` (one ``nvcc`` per
   source, in parallel).
2. K1 (``csrc/raster.cu``) against its plain torch version on the card, at
   the main path's extraction shape (the six songs of
   ``mst_torch/assets/smoke``: 6 x 8 channels x 128 bars x 4 beats x 10
   fractions rows, 280 and 94 lanes) and on a collision-heavy random case:
   bit-equal.
3. K2 (``csrc/grid_tail.cu``) against its plain version at the apply shape
   (12 jobs: 491,520 rows), within ``K2_ATOL``.
4. Each kernel's time (CUDA events, warmed up, many launches), its plain
   version's, the one PyTorch call that computes the same function where
   there is one, and the bound: the larger of the bytes the function must
   move over 3.35 TB/s and its operations over 67 TFLOP/s (fp32), the
   H100 SXM's published peaks.
5. The main path: ``transfer_styles`` with the ``snapshots/4900`` weights
   on 3 compositions x 3 styles (12 jobs) on ``cuda``, once to warm up and
   once with every launch counter at 0, which must see each kernel launch.
   Every output parses and every styled output has notes. One more request
   runs under torch.profiler: its device-busy time beside its wall time,
   and the device time by kernel. Then 1
   composition x 1 style runs on the card and on the CPU, and the two sets
   of files must agree under the fp32-boundary rule (mst_torch.parity).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside this file, it exits non-zero and prints no
result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TOL = 0.0      # K1 is exact: a max of the same fp32 values
K2_ATOL = 1e-6    # K2 is built without FMA contraction: expected bit-equal
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_setup(torch):
    from mst_torch.io import native
    from mst_torch.ops import cuda_build
    from mst_torch.transfer import strict_fp32

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    strict_fp32()
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log("midi codec: " + ("native (native/libmidicodec.so)"
                          if native._load() is not None else "pure Python"))
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'already built'})")
    for name, out in sorted(logs.items()):
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def smoke_paths():
    smoke = os.path.join(ROOT, "mst_torch", "assets", "smoke")
    with open(os.path.join(smoke, "manifest.json")) as fh:
        names = [s["name"] for s in json.load(fh)["songs"]]
    comps = [os.path.join(smoke, f"{n}.mid") for n in names
             if n.startswith("comp_")]
    styles = [os.path.join(smoke, f"{n}.mid") for n in names
              if n.startswith("style_")]
    return comps, styles


def phase_k1(torch, bundle, songs):
    """K1 vs plain at the extraction shape, plus a collision-heavy case."""
    from mst_torch.ops import raster_kernel as rk
    from mst_torch.transfer import _extract_inputs

    inputs, _ = _extract_inputs(bundle, songs, 4, True)
    B, Cb, Rb, T = (inputs[k] for k in ("B", "Cb", "Rb", "T"))
    cases = [("pitched", inputs["p_notes"], B * Cb * Rb * T * 10, 56, 5),
             ("unpitched", inputs["u_notes"], B * Rb * T * 10, 47, 2)]
    g = torch.Generator().manual_seed(1)
    n = 1 << 18
    n_rows = 4096                      # ~64 notes per row: heavy collisions
    rand = (torch.randint(0, n_rows + 64, (n,), generator=g,
                          dtype=torch.int32),
            torch.randint(0, 56, (n,), generator=g, dtype=torch.int32),
            torch.randint(0, 3, (n,), generator=g, dtype=torch.int32),
            torch.rand(n, generator=g) * 6, torch.rand(n, generator=g),
            torch.rand(n, generator=g) > 0.05)
    cases.append(("collisions", tuple(t.cuda() for t in rand), n_rows, 56, 5))
    max_err = 0.0
    for name, notes, rows, n_notes, n_feat in cases:
        got = rk.rasterize(*notes, rows, n_notes, n_feat)
        want = rk.segment_rasterize_plain(*notes, rows, n_notes, n_feat)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want) or err > K1_TOL:
            raise AssertionError(f"K1 {name}: not bit-equal (max |err| {err})")
        log(f"K1 {name}: rows {rows} x {n_notes * n_feat} lanes, "
            f"{notes[0].shape[0]} notes: bit-equal")

    # timing at the main path's pitched shape
    _, notes, rows, n_notes, n_feat = cases[0]
    lanes = n_notes * n_feat
    ms = cuda_ms(lambda: rk.rasterize(*notes, rows, n_notes, n_feat), 50)
    plain = cuda_ms(lambda: rk.segment_rasterize_plain(
        *notes, rows, n_notes, n_feat), 20)
    # the one PyTorch call: scatter_reduce_ amax of the same (index, value)
    # pairs onto a zero base
    row, note, acc, dur, vel, valid = notes
    keep = valid & (row < rows)
    r = row[keep].long() * lanes
    l0 = note[keep].long() * n_feat
    idx = torch.cat([r + l0, r + l0 + 1, r + l0 + 2 + acc[keep].long()])
    val = torch.cat([dur[keep], vel[keep], torch.ones_like(dur[keep])])
    library = cuda_ms(lambda: torch.zeros(rows * lanes, device="cuda")
                      .scatter_reduce_(0, idx, val, "amax"), 50)
    in_bytes = sum(t.numel() * t.element_size() for t in notes)
    b_ms, b_by = bound_ms(in_bytes + rows * lanes * 4, 3 * int(keep.sum()))
    return dict(name="raster", route="cuda", source="mst_torch/csrc/raster.cu",
                replaces="mst_tpu/ops/pallas_raster.py:96",
                max_abs_err=max_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=library)


def phase_k2(torch):
    """K2 vs plain at the apply shape of 12 jobs."""
    from mst_torch.ops import grid_kernel as gk

    L = (12, 8, 128, 4, 10)
    g = torch.Generator().manual_seed(2)
    xo = torch.randn(*L, 8, 30, generator=g).cuda()
    xd = torch.randn(*L, 7, 30, generator=g).cuda()
    w = (torch.randn(30, 5, generator=g) * 0.3).cuda()
    rest = torch.randn(L[0], 1, *L[2:], 56, 5, generator=g).cuda()
    scale = (6.0, 1.0, 1.0, 1.0, 1.0)
    got = gk.grid_tail(xo, xd, w, rest, scale)
    want = gk.grid_tail_plain(xo, xd, w, rest, scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    n_diff = int((got != want).sum())
    if not err <= K2_ATOL:
        raise AssertionError(f"K2: max |err| {err} > {K2_ATOL}")
    n = xo.numel() // 240
    log(f"K2: {n} rows, max |err| {err} (tolerance {K2_ATOL}), "
        f"{n_diff} of {got.numel()} values differ")
    ms = cuda_ms(lambda: gk.grid_tail(xo, xd, w, rest, scale), 50)
    plain = cuda_ms(lambda: gk.grid_tail_plain(xo, xd, w, rest, scale), 3,
                    warmup=1)
    n_bytes = 4 * (xo.numel() + xd.numel() + w.numel() + rest.numel()
                   + got.numel())
    # per (row, o, d): 30 x (add, leaky, 5 multiplies, 5 adds) + 5 x (add,
    # exp, add, divide, scale)
    n_ops = n * 56 * (30 * 12 + 5 * 5)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return dict(name="grid_tail", route="cuda",
                source="mst_torch/csrc/grid_tail.cu",
                replaces="mst_tpu/ops/pallas_grid.py:217", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_outputs(written, label):
    from mst_torch.io import smf
    for path in written:
        with open(path, "rb") as fh:
            data = smf.parse_midi_bytes(fh.read())
        styled = "style).mid" in os.path.basename(path)
        n_on = sum(int((t.type == smf.EV_NOTE_ON).sum()) for t in data.tracks)
        if styled and n_on == 0:
            raise AssertionError(f"{label}: styled output has no notes: "
                                 f"{path}")
    log(f"{label}: {len(written)} files parse; every styled output has notes")


def phase_main(torch, bundle, comps, styles, tmp):
    from mst_torch.ops import grid_kernel, raster_kernel
    from mst_torch.parity import midi_differences
    from mst_torch.transfer import ModelBundle, transfer_styles

    out = os.path.join(tmp, "warm")
    t0 = time.perf_counter()
    transfer_styles(bundle, comps, styles, out)
    torch.cuda.synchronize()
    log(f"main path warm-up: {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    raster_kernel.rasterize.launches = 0
    grid_kernel.grid_tail.launches = 0
    t0 = time.perf_counter()
    written = transfer_styles(bundle, comps, styles,
                              os.path.join(tmp, "gpu"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"raster": raster_kernel.rasterize.launches,
                "grid_tail": grid_kernel.grid_tail.launches}
    n_jobs = len(comps) * (1 + len(styles))
    log(f"main path: {len(comps)} compositions x {len(styles)} styles "
        f"({n_jobs} jobs) in {wall:.3f} s per request, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path launched no {name} kernel")
    check_outputs(written, "main path")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transfer_styles(bundle, comps, styles, os.path.join(tmp, "prof"))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel events carry the device time; their CPU-side ops repeat it
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type != DeviceType.CPU)
    log(f"profiled request: device busy {busy_us / 1e3:.3f} ms of "
        f"{prof_wall * 1e3:.3f} ms wall")
    log(events.table(sort_by="self_cuda_time_total", row_limit=15,
                     max_name_column_width=60))

    # one composition x one style on the card and on the CPU
    gpu = transfer_styles(bundle, comps[:1], styles[:1],
                          os.path.join(tmp, "pair_gpu"))
    t0 = time.perf_counter()
    cpu = transfer_styles(ModelBundle.from_npz(device="cpu"), comps[:1],
                          styles[:1], os.path.join(tmp, "pair_cpu"))
    log(f"1 x 1 on the CPU: {time.perf_counter() - t0:.3f} s")
    for a, b in zip(gpu, cpu):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            equal, faults, borderline = midi_differences(fa.read(), fb.read())
        if faults:
            raise AssertionError(f"GPU vs CPU {os.path.basename(a)}: "
                                 f"{faults}")
        log(f"GPU vs CPU {os.path.basename(a)}: "
            + ("byte-equal" if equal else
               f"{len(borderline)} fp32-boundary note events"))
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mst_torch")):
        print("chip_smoke: mst_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mst_torch.transfer import ModelBundle, get_model_input

    phase_setup(torch)
    comps, styles = smoke_paths()
    t0 = time.perf_counter()
    songs = [get_model_input(p)[1] for p in comps + styles]
    log(f"host ingest of {len(songs)} songs: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    bundle = ModelBundle.from_npz(device="cuda")
    k1 = phase_k1(torch, bundle, songs)
    k2 = phase_k2(torch)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main(torch, bundle, comps, styles, tmp)
    k1["launches"] = launches["raster"]
    k2["launches"] = launches["grid_tail"]
    kernels = [k1, k2]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}), {k['launches']} launches per request")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
