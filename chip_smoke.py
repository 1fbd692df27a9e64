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
   fractions rows, 280 and 94 lanes), on a collision-heavy random case and
   on an unsorted edge-value case (negative values, +-0.0, NaN of both
   signs, +-inf, denormals, sentinel rows and rows past the raster):
   bit-equal, NaN where the plain version has NaN. One ``rasterize`` call
   at the extraction shape runs under
   ``torch.cuda.set_sync_debug_mode("error")``: it must not synchronise.
3. K2 (``csrc/grid_tail.cu``) against its plain version at the apply shape
   (12 jobs: 491,520 rows) with ``rest`` per song and at full shape, and
   at 63 and 30 rows (a ragged last tile, rest blocks that cross tiles or
   are shorter than one), within ``K2_ATOL``, with the count of values
   that differ. One ``grid_tail_fwd`` call at the apply shape must not
   synchronise. K2's launch shape (threads, shared memory, blocks per SM).
4. Each kernel's time (CUDA events, warmed up, many launches), its plain
   version's, the one PyTorch call that computes the same function where
   there is one, and the bound: the larger of the bytes the function must
   move over 3.35 TB/s and its operations over 67 TFLOP/s (fp32), the
   H100 SXM's published peaks. Beside K1, ``torch.zeros`` of its raster
   alone; beside K2, its time at the batch-6 training shape (122,880 rows)
   and in its copy-only and compute-only modes.
5. The serving path: ``transfer_styles`` with the ``snapshots/4900``
   weights on 3 compositions x 3 styles (12 jobs) on ``cuda``, once to warm
   up and once with every launch counter at 0, which must see K1 and K2
   launch. Every output parses and every styled output has notes. One more
   request runs under torch.profiler: its device-busy time beside its wall
   time, and the device time by kernel. Then 1 composition x 1 style runs
   on the card and on the CPU, and the two sets of files must agree under
   the fp32-boundary rule (mst_torch.parity).
6. K3 (``csrc/grid_tail_bwd.cu``) against its plain version at the
   327,680-row budget shape (8 x 8 x 128 x 4 x 10, ``batch_cell_budget``)
   and at 63 and 30 rows (ragged last tiles) with a random cotangent,
   within ``K3_RTOL`` and ``K3_W_RTOL``, with the count of values that
   differ; two runs must be bit-equal, and an input view that does not
   start on a 16-byte boundary must give the aligned call's bits. One
   ``grid_tail_bwd`` call and one ``GridTail`` backward at the budget
   shape must not synchronise. Then
   ``GridTail``'s K2+K3 gradients against torch autograd of
   ``grid_tail_plain`` on the card, on a small case. K3's launch shape,
   its time, its plain version's and its bound; the kernel alone in its
   full, copy-only and compute-only modes; and its time with a cold L2 at
   the training step's shapes (10,240, 20,480 and 122,880 rows).
7. The training path at full width (``ModelConfig()``) from a seed-108
   fresh init on the six smoke songs: 8 batch-1 micro-steps and 2 batch-6
   steps through ``create_train_state``, ``device_batch_from_songs`` and
   ``make_train_step`` (Adam + StepLR, iter_size 2), with every launch
   counter at 0 first; each of K1, K2 and K3 must launch and every loss
   must be finite. It prints the ms per step after warm-up, the
   device-busy share of one profiled step and the peak memory. The first
   step's losses and per-leaf gradients on the card must match the same
   step on the CPU (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_TOL``), and a save
   after step 4 and a resume must reproduce step 5's losses
   (``RESUME_RTOL``).
8. The bf16 precision policies (mst_torch.ops.precision): the bf16 forms
   of K1 (a bf16 raster), K2 and K3 (bf16 storage) against their plain
   versions, at the shapes and on the cases of phases 2, 3 and 6 (K1
   bit-equal; K2 bit-equal; K3's row cotangents bit-equal, ct_w within
   ``K3_W_RTOL``, two runs bit-equal), none synchronising, each timed
   beside its bound at bf16 widths (run inside phases 2, 3 and 6). A
   12-job request with ``extract_storage_dtype="bfloat16"`` must launch
   K1's bf16 form twice, and its files parse; the share of note events
   that differ from the fp32 request is printed. Then the training run of
   phase 7 again with ``ModelConfig(storage_dtype="bfloat16",
   compute_dtype="bfloat16")``: the bf16 forms of K1, K2 and K3 must each
   launch and no fp32 tail kernel may; every loss finite; the first step
   against the CPU's within ``TRAIN_BF16_LOSS_TOL`` and
   ``TRAIN_BF16_GRAD_TOL``; ms per step, device-busy share and peak memory
   beside the fp32 run's. The bf16 forms of K2 and K3 must give their
   plain versions' bits (0 values differ; ct_w within ``K3_W_RTOL``), also
   on an edge-value case (``bf16_edge_values``: sums on bf16 rounding
   ties, bf16 subnormals, +-0, 1e30), where the sign of every zero counts.
   One bf16 micro-step with ``TrainConfig(remat=True)`` must give the
   same step's losses and gradients without remat bit for bit. Each tail
   form prints its share of its bound, and each bf16 form its time against
   the fp32 form's in this call.
9. Serving and eval (run after phase 5, on its request):
   ``batch-style-transfer-torch.py --weights <the committed npz> --device
   cuda`` on the 3 x 3 smoke request in a process of its own must exit 0,
   print the set of paths the in-process request of phase 5 wrote, and
   write byte-equal files; run again without weights (``demo_params(seed
   0)``) it must exit 0 and write files that parse. ``extract_style`` of
   one composition and one style, then ``apply_styles`` of that job, with
   the launch counters at 0 first, must launch K1 and K2 and write the
   file of that job of phase 5's 1 x 1 request byte for byte (and the
   12-job request's under the fp32-boundary rule: it buckets the latents
   at 128 bars, not 96). ``transfer_and_evaluate``
   of one composition and the three styles, counters at 0 first, must
   launch K1 and K2; its keys are the generated files, every score lies
   in [-1, 1] (or is None for a silent file, on the CPU too), and each is
   within ``EVAL_ATOL`` of ``spectral_similarity_midi(..., device="cpu")``
   on the same files. It prints the CLI's wall time, the eval's wall time
   and the share its scoring took, and the largest card-CPU gap.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
form; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside this file, it exits non-zero and prints no
result.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TOL = 0.0      # K1 is exact: a max of the same fp32 values
K2_ATOL = 1e-6    # K2 is built without FMA contraction: expected bit-equal
# K3's row cotangents (ct_y, ct_xo, ct_xd) round each operation in the same
# order as the plain version (--fmad=false): expected bit-equal; the
# tolerance is relative to the largest |value|. ct_w sums 18 million terms
# in another order (per-block sums, then torch's sum, against one matrix
# product): relative to its largest |value|.
K3_RTOL = 1e-6
K3_W_RTOL = 1e-4
# the first training step on the card against the CPU: both run fp32 with
# other summation orders (cuDNN, cuBLAS and torch's CPU kernels), through
# 128-step LSTM recurrences and sums over every raster cell; the first card
# run measured 1.9e-7 on the losses and 5.9e-6 on the gradients
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4     # per leaf, relative to the leaf's largest |grad|
# step 5 after a resume runs the same forward on the same parameters
# (measured bit-equal); the tolerance allows another cuDNN algorithm
RESUME_RTOL = 1e-6
# the first bf16-storage, bf16-compute step on the card against the CPU:
# both round at the same points, but the card's bf16 GEMMs and convolution
# sum in other orders than the CPU's fp32 products of bf16 values, and a
# sum that lands on the other side of a bf16 rounding boundary moves by
# 2**-8 relative and carries that downstream. Losses: |diff| <= rtol |cpu|
# + atol (the atol covers components near 0); gradients per leaf, relative
# to the leaf's largest |grad|.
TRAIN_BF16_LOSS_TOL = (1e-2, 1e-3)
TRAIN_BF16_GRAD_TOL = 5e-2
# transfer_and_evaluate's scores on the card against the same files scored
# on the CPU: cuFFT against the CPU's FFT and sums in other orders, in fp32
EVAL_ATOL = 1e-4
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


def device_busy_us(events):
    """Device time of a profile's kernels (key_averages()): the events on
    the device, without user annotations such as the optimizer's step
    range, which would count its kernels twice."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False))


def _counters():
    """(name in the kernels line, wrapper, counter attribute) of every
    kernel form."""
    from mst_torch.ops import grid_kernel, raster_kernel
    wrappers = (("raster", raster_kernel.rasterize),
                ("grid_tail", grid_kernel.grid_tail),
                ("grid_tail_bwd", grid_kernel.grid_tail_bwd))
    return [(name + suffix, fn, attr) for name, fn in wrappers
            for suffix, attr in (("", "launches"),
                                 ("_bf16", "launches_bf16"))]


def reset_launches():
    """Every kernel form's launch count to 0."""
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_launches():
    """Every kernel form's launch count, by the name in the kernels line."""
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


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
    # the bf16 compute policy's products: bf16 operands, an fp32 result
    a = torch.ones(8, 16, dtype=torch.bfloat16, device="cuda")
    for name, product, args in (("mm", torch.mm, (a, a.t())),
                                ("bmm", torch.bmm, (a[None], a.t()[None]))):
        out = product(*args, out_dtype=torch.float32)
        if out.dtype != torch.float32 or out.flatten()[0].item() != 16.0:
            raise AssertionError(f"torch.{name}(out_dtype=float32) gave "
                                 f"{out.dtype}")
    log("torch.mm and torch.bmm take out_dtype=float32 for bf16 operands")
    log("midi codec: " + ("native (native/libmidicodec.so)"
                          if native._load() is not None else "pure Python"))
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'already built'})")
    for name, out in sorted(logs.items()):
        function = name
        for line in out.splitlines():
            if "Function properties for" in line:
                # a kernel template's instance: its mode (FULL is 0) and
                # form (Lb1 and t: bf16)
                m = re.search(r"ILi(\d+)ELb(\d)E", line)
                form = ("bf16" if re.search(r"Lb1E|IjE|ItE", line)
                        else "fp32")
                function = (f"mode {m.group(1)} {form}" if m
                            else f"kernel {form}")
            if "Used" in line or "spill" in line:
                log(f"  {name}: {function}: {line.strip()}")


def smoke_paths():
    smoke = os.path.join(ROOT, "mst_torch", "assets", "smoke")
    with open(os.path.join(smoke, "manifest.json")) as fh:
        names = [s["name"] for s in json.load(fh)["songs"]]
    comps = [os.path.join(smoke, f"{n}.mid") for n in names
             if n.startswith("comp_")]
    styles = [os.path.join(smoke, f"{n}.mid") for n in names
              if n.startswith("style_")]
    return comps, styles


def raster_bits_equal(torch, got, want):
    """NaN where ``want`` has NaN, equal bits everywhere else (fp32 or
    bf16 rasters)."""
    nan = torch.isnan(want)
    ints = torch.int32 if want.dtype == torch.float32 else torch.int16
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got.view(ints)[~nan], want.view(ints)[~nan]))


def edge_records(torch, n, n_rows, n_notes):
    """Unsorted pitched records whose values are edge cases of the max:
    negative durations and velocities, +-0.0, NaN of both signs, +-inf and
    a denormal, on few rows (collisions), with sentinel rows, rows past
    the raster and invalid notes."""
    g = torch.Generator().manual_seed(4)
    edges = torch.tensor([-1.5, -0.0, 0.0, float("nan"), -float("nan"),
                          float("inf"), -float("inf"), 1e-40, -1e-40, 0.25,
                          3.0])
    pick = lambda: edges[torch.randint(0, len(edges), (n,), generator=g)]
    row = torch.randint(0, n_rows + 16, (n,), generator=g, dtype=torch.int32)
    row = torch.where(torch.rand(n, generator=g) < 0.05, 2 ** 30, row)
    return (row.to(torch.int32),
            torch.randint(0, n_notes, (n,), generator=g, dtype=torch.int32),
            torch.randint(0, 3, (n,), generator=g, dtype=torch.int32),
            pick(), pick(), torch.rand(n, generator=g) > 0.05)


def assert_no_sync(torch, label, fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): a call that
    waits for the device raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{label}: no host synchronisation (sync debug mode 'error')")


def phase_k1(torch, bundle, songs):
    """K1 vs plain at the extraction shape, a collision-heavy case and an
    edge-value case, in both forms (fp32 and bf16 rasters); no host sync;
    K1 against the zero-fill alone. Returns the kernels-line entries of
    the two forms."""
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
    edge = tuple(t.cuda() for t in edge_records(torch, 1 << 16, 1024, 56))
    cases.append(("edge values", edge, 1024, 56, 5))
    entries = []
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        label = "K1" + (" bf16" if suffix else "")
        max_err = 0.0
        for name, notes, rows, n_notes, n_feat in cases:
            got = rk.rasterize(*notes, rows, n_notes, n_feat, dtype)
            want = rk.segment_rasterize_plain(*notes, rows, n_notes, n_feat,
                                              dtype)
            torch.cuda.synchronize()
            if got.dtype != dtype or not raster_bits_equal(torch, got, want):
                raise AssertionError(f"{label} {name}: not bit-equal")
            finite = torch.isfinite(want)
            err = (got[finite].float() - want[finite].float()).abs().max()
            err = err.item()
            max_err = max(max_err, err)
            if err > K1_TOL:
                raise AssertionError(f"{label} {name}: max |err| {err}")
            log(f"{label} {name}: rows {rows} x {n_notes * n_feat} lanes, "
                f"{notes[0].shape[0]} notes: bit-equal"
                + (f" ({int(torch.isnan(want).sum())} NaN cells, NaN in "
                   f"both)" if name == "edge values" else ""))
            del got, want

        # the main path's pitched shape
        _, notes, rows, n_notes, n_feat = cases[0]
        lanes = n_notes * n_feat
        assert_no_sync(torch, f"{label} rasterize at the extraction shape",
                       lambda: rk.rasterize(*notes, rows, n_notes, n_feat,
                                            dtype))
        ms = cuda_ms(lambda: rk.rasterize(*notes, rows, n_notes, n_feat,
                                          dtype), 50)
        zero_ms = cuda_ms(lambda: torch.zeros(rows * lanes, dtype=dtype,
                                              device="cuda"), 50)
        plain = cuda_ms(lambda: rk.segment_rasterize_plain(
            *notes, rows, n_notes, n_feat, dtype), 20)
        # the one PyTorch call: scatter_reduce_ amax of the same (index,
        # value) pairs onto a zero base of the raster's dtype
        row, note, acc, dur, vel, valid = notes
        keep = valid & (row < rows)
        r = row[keep].long() * lanes
        l0 = note[keep].long() * n_feat
        idx = torch.cat([r + l0, r + l0 + 1, r + l0 + 2 + acc[keep].long()])
        val = torch.cat([dur[keep], vel[keep],
                         torch.ones_like(dur[keep])]).to(dtype)
        library = cuda_ms(lambda: torch.zeros(rows * lanes, dtype=dtype,
                                              device="cuda")
                          .scatter_reduce_(0, idx, val, "amax"), 50)
        in_bytes = sum(t.numel() * t.element_size() for t in notes)
        out_bytes = rows * lanes * torch.finfo(dtype).bits // 8
        b_ms, b_by = bound_ms(in_bytes + out_bytes, 3 * int(keep.sum()))
        log(f"{label} split at {rows} x {lanes}: kernel {ms:.4f} ms, "
            f"torch.zeros of the raster alone {zero_ms:.4f} ms, "
            f"scatter_reduce_ {library:.4f} ms, bound {b_ms:.4f} ms")
        entries.append(dict(
            name="raster" + suffix, route="cuda",
            source="mst_torch/csrc/raster.cu",
            replaces="mst_tpu/ops/pallas_raster.py:96", max_abs_err=max_err,
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=library, detail={"zero_fill_ms": zero_ms}))
    return entries


def tail_inputs(torch, lead, seed, full_rest=False, bf16=False):
    """Random tail inputs at lead shape ``lead`` on the card; with
    ``bf16`` xo and xd are bf16 (the bf16 form's inputs)."""
    g = torch.Generator().manual_seed(seed)
    rest_lead = lead if full_rest else (lead[0], 1) + tuple(lead[2:])
    store = torch.bfloat16 if bf16 else torch.float32
    return (torch.randn(*lead, 8, 30, generator=g).cuda().to(store),
            torch.randn(*lead, 7, 30, generator=g).cuda().to(store),
            (torch.randn(30, 5, generator=g) * 0.3).cuda(),
            torch.randn(*rest_lead, 56, 5, generator=g).cuda())


def tail_bound_ms(n, rest_rows, bf16=False):
    """K2's bound for n rows and rest_rows rest rows: xo, xd, w and rest
    read once, out written once (xo, xd and out at 2 bytes in the bf16
    form); per (row, o, d) 30 x (add, leaky, 5 multiplies, 5 adds) + 5 x
    (add, exp, add, divide, scale)."""
    e = 2 if bf16 else 4
    n_bytes = e * n * (240 + 210 + 280) + 4 * (150 + rest_rows * 280)
    return bound_ms(n_bytes, n * 56 * (30 * 12 + 5 * 5))


def tail_launch_info(bf16=False):
    """K2's (dynamic shared memory bytes, threads per block, resident
    blocks per SM) on this card, in one form."""
    import ctypes

    from mst_torch.ops import cuda_build

    info = (ctypes.c_int * 3)()
    fn = cuda_build.load("grid_tail").mst_grid_tail_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rc = fn(int(bf16), info)
    if rc != 0:
        raise RuntimeError(f"K2 launch info: CUDA error {rc}")
    return tuple(info)


def tail_variant_ms(torch, xo, xd, w, rest, lead):
    """K2's time in its two measuring modes (csrc/grid_tail.cu, ``Mode``):
    the same launch moving its bytes only, and computing only, in the form
    of xo's dtype."""
    import ctypes

    from mst_torch.ops import cuda_build, grid_kernel as gk

    fn = cuda_build.load("grid_tail").mst_grid_tail_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rep, inner = gk._rest_layout(lead, rest.shape)
    out = torch.empty(*lead, 56, 5, dtype=xo.dtype, device="cuda")
    bf16 = int(xo.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for mode, name in ((1, "copy_only_ms"), (2, "compute_only_ms")):
        def run():
            rc = fn(mode, bf16, xo.data_ptr(), xd.data_ptr(), w.data_ptr(),
                    rest.data_ptr(), out.data_ptr(), xo.numel() // 240, rep,
                    inner, stream)
            if rc != 0:
                raise RuntimeError(f"K2 mode {mode}: CUDA error {rc}")
        times[name] = cuda_ms(run, 50)
    return times


def phase_k2(torch):
    """K2 vs plain at the apply shape of 12 jobs in both rest layouts and
    at ragged row counts, in both forms (the bf16 form at the apply shape
    with rest per song); no host sync; K2's time there and at the batch-6
    training shape. Returns the entries of the two forms."""
    from mst_torch.ops import grid_kernel as gk

    scale = (6.0, 1.0, 1.0, 1.0, 1.0)
    L = (12, 8, 128, 4, 10)
    entries = []
    for bf16 in (False, True):
        label = "K2 bf16" if bf16 else "K2"
        smem, threads, per_sm = tail_launch_info(bf16)
        log(f"{label} launch: {threads} threads a block, {smem} B of "
            f"dynamic shared memory, {per_sm} blocks per SM")
        max_err = 0.0
        # (label, lead, full rest): the 12-job apply shape, then 63 rows (a
        # ragged last tile; rest blocks of 21 rows cross tiles) and 30 rows
        # (rest blocks of 5 rows, shorter than a tile)
        shapes = [("12 jobs", L, False), ("12 jobs", L, True),
                  ("63 rows", (1, 3, 7, 3, 1), False),
                  ("63 rows", (1, 3, 7, 3, 1), True),
                  ("30 rows", (2, 3, 1, 1, 5), False)]
        for case, lead, full in shapes:
            if bf16 and full and case == "12 jobs":
                continue
            xo, xd, w, rest = tail_inputs(torch, lead, 2, full, bf16)
            got = gk.grid_tail(xo, xd, w, rest, scale)
            want = gk.grid_tail_plain(xo, xd, w, rest, scale)
            torch.cuda.synchronize()
            if got.dtype != xo.dtype:
                raise AssertionError(f"{label} {case}: output {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            n_diff = int((got != want).sum())
            max_err = max(max_err, err)
            if not err <= K2_ATOL or (bf16 and n_diff):
                raise AssertionError(f"{label} {case}: max |err| {err} > "
                                     f"{K2_ATOL} or {n_diff} values differ")
            log(f"{label} {case} ({xo.numel() // 240} rows, "
                f"{'full' if full else 'per-song'} rest): max |err| {err} "
                f"(tolerance {K2_ATOL}), {n_diff} of {got.numel()} values "
                f"differ")
            del got, want

        xo, xd, w, rest = tail_inputs(torch, L, 2, bf16=bf16)
        n = xo.numel() // 240
        assert_no_sync(torch, f"{label} grid_tail_fwd at {n} rows",
                       lambda: gk.grid_tail_fwd(xo, xd, w, rest, scale))
        ms = cuda_ms(lambda: gk.grid_tail(xo, xd, w, rest, scale), 50)
        plain = cuda_ms(lambda: gk.grid_tail_plain(xo, xd, w, rest, scale),
                        3, warmup=1)
        b_ms, b_by = tail_bound_ms(n, rest.numel() // 280, bf16)
        # the batch-6 training step's shape (6 songs x 4 channels x 128 bars)
        args = tail_inputs(torch, (6, 4, 128, 4, 10), 5, bf16=bf16)
        rows = args[0].numel() // 240
        b6_ms = cuda_ms(lambda: gk.grid_tail(*args, scale), 50)
        b6_bound, _ = tail_bound_ms(rows, args[3].numel() // 280, bf16)
        log(f"{label} at {n} rows: {ms:.4f} ms (bound {b_ms:.4f} ms: "
            f"{b_ms / ms:.1%} of the bound); at the batch-6 step's {rows} "
            f"rows: {b6_ms:.4f} ms (bound {b6_bound:.4f} ms)")
        detail = {"share_of_bound": b_ms / ms, f"ms_{rows}_rows": b6_ms,
                  f"bound_ms_{rows}_rows": b6_bound}
        detail.update(tail_variant_ms(torch, xo, xd, w, rest, L))
        log(f"{label} split at {n} rows: copy only "
            f"{detail['copy_only_ms']:.4f} ms, compute only "
            f"{detail['compute_only_ms']:.4f} ms, both {ms:.4f} ms")
        entries.append(dict(
            name="grid_tail_bf16" if bf16 else "grid_tail", route="cuda",
            source="mst_torch/csrc/grid_tail.cu",
            replaces="mst_tpu/ops/pallas_grid.py:217", max_abs_err=max_err,
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, detail=detail))
        del xo, xd, w, rest, args
    return entries


def cuda_ms_cold(fn, iters, warmup=3, flush_bytes=256 << 20):
    """Mean device time of ``fn`` in ms over ``iters`` calls, each timed
    alone with a cold L2: a 256 MB write evicts the 50 MB L2 before each
    call, and a device-side sleep before that lets the host enqueue the
    call ahead of the device, so the events see the kernels alone."""
    import torch
    flush = torch.empty(flush_bytes // 4, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(500_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


K3_SCALE = (6.0, 1.0, 1.0, 1.0, 1.0)


def k3_case(torch, lead, seed, bf16=False):
    """K3's inputs at lead shape ``lead`` on the card: the tail's inputs,
    its output by K2 and a random cotangent, in one form."""
    from mst_torch.ops import grid_kernel as gk
    xo, xd, w, rest = tail_inputs(torch, lead, seed, bf16=bf16)
    out = gk.grid_tail_fwd(xo, xd, w, rest, K3_SCALE)
    g = torch.Generator().manual_seed(seed + 1)
    ct = torch.randn(*lead, 56, 5, generator=g).cuda().to(xo.dtype)
    return xo, xd, out, ct, w, rest


def k3_bound_ms(n, bf16=False):
    """K3's bound for n rows. Bytes: xo, xd, out and ct read once, ct_xo,
    ct_xd and ct_y written once (all but ct_y at 2 bytes in the bf16 form;
    w, the scales and the ct_w partials are small). Operations per (row,
    o, d): ct_y (5 x: multiply, subtract, 3 multiplies) and per k: gp (1),
    ct_G (5 multiplies, 4 adds), dLR (1), the two sums (2), LR(gp) (1),
    ct_w (5 multiplies, 5 adds) = 24."""
    e = 2 if bf16 else 4
    n_bytes = n * (e * (240 + 210 + 280 + 280 + 240 + 210) + 4 * 280)
    return bound_ms(n_bytes, n * 56 * (5 * 5 + 30 * 24))


def k3_kernel_ms(torch, case, modes):
    """K3's kernel alone (no ct_w sum), by its C entry, in each of
    ``modes`` (csrc/grid_tail_bwd.cu, ``Mode``: 0 full, 1 copy only, 2
    compute only), with unit scales, in the form of xo's dtype: {mode:
    ms}."""
    import ctypes

    from mst_torch.ops import cuda_build, grid_kernel as gk

    fn = cuda_build.load("grid_tail_bwd").mst_grid_tail_bwd_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    xo, xd, out, ct, w = case[:5]
    n = xo.numel() // 240
    _, _, per_sm, rows = gk._bwd_entry()[1][xo.dtype]
    blocks = gk.bwd_grid(n, per_sm, torch.cuda.get_device_properties(
        0).multi_processor_count, rows)
    outs = [torch.empty_like(xo), torch.empty_like(xd),
            torch.empty(ct.shape, device="cuda")]
    parts = torch.empty(blocks, 30, 5, device="cuda")
    bf16 = int(xo.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for mode in modes:
        def run():
            rc = fn(mode, bf16, *(t.data_ptr() for t in (xo, xd, out, ct, w)),
                    *(t.data_ptr() for t in outs), parts.data_ptr(), n,
                    blocks, stream)
            if rc != 0:
                raise RuntimeError(f"K3 mode {mode}: CUDA error {rc}")
        times[mode] = cuda_ms(run, 20)
    return times


def phase_k3(torch, L=(8, 8, 128, 4, 10)):
    """K3 vs plain at the 327,680-row budget shape ``L`` and at ragged row
    counts, in both forms; determinism, no host sync, GridTail's gradients
    against autograd of the plain forward (fp32 form); K3's time there, in
    its measuring modes and at the training step's shapes. Returns the
    entries of the two forms."""
    from mst_torch.ops import grid_kernel as gk

    scale = K3_SCALE
    entries = []
    for bf16 in (False, True):
        label = "K3 bf16" if bf16 else "K3"
        dtype = torch.bfloat16 if bf16 else torch.float32
        smem, threads, per_sm, rows_per_tile = gk._bwd_entry()[1][dtype]
        log(f"{label} launch: {threads} threads a block, {smem} B of "
            f"dynamic shared memory, {per_sm} blocks per SM, "
            f"{rows_per_tile} rows a tile")
        max_err = 0.0
        # the budget shape, 63 rows (7 whole tiles and a ragged one of 7
        # rows) and 30 rows (3 whole tiles and one of 6)
        for case, lead in (("budget", L), ("63 rows", (1, 3, 7, 3, 1)),
                           ("30 rows", (2, 3, 1, 1, 5))):
            xo, xd, out, ct, w, _ = k3_case(torch, lead, 3, bf16)
            got = gk.grid_tail_bwd(xo, xd, out, ct, w, scale)
            again = gk.grid_tail_bwd(xo, xd, out, ct, w, scale)
            want = gk.grid_tail_bwd_plain(xo, xd, out, ct, w, scale)
            torch.cuda.synchronize()
            n = xo.numel() // 240
            for name, a, b, c in zip(("ct_xo", "ct_xd", "ct_y", "ct_w"), got,
                                     again, want):
                if a.dtype != c.dtype or not torch.equal(a, b):
                    raise AssertionError(f"{label} {case} {name}: two runs "
                                         f"differ or dtype {a.dtype}")
                err = (a.float() - c.float()).abs().max().item()
                largest = c.abs().max().item()
                tol = (K3_W_RTOL if name == "ct_w" else K3_RTOL) * largest
                n_diff = int((a != c).sum())
                if not err <= tol or (bf16 and name != "ct_w" and n_diff):
                    raise AssertionError(f"{label} {case} {name}: max |err| "
                                         f"{err} > {tol} or {n_diff} values "
                                         f"differ")
                max_err = max(max_err, err)
                log(f"{label} {case} ({n} rows) {name} ({a.dtype}): max "
                    f"|err| {err} (largest |value| {largest:.6g}, tolerance "
                    f"{tol:.3g}), {n_diff} of {a.numel()} "
                    f"values differ; two runs bit-equal")
            del got, again, want

        # an input view off a 16-byte boundary: the wrapper copies it
        xo, xd, out, ct, w, _ = k3_case(torch, (1, 3, 7, 3, 1), 4, bf16)
        shifted = torch.empty(xo.numel() + 1, dtype=dtype,
                              device="cuda")[1:].view_as(xo)
        shifted.copy_(xo)
        for a, b in zip(gk.grid_tail_bwd(shifted, xd, out, ct, w, scale),
                        gk.grid_tail_bwd(xo, xd, out, ct, w, scale)):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} on a misaligned view differs")
        log(f"{label} on an xo view at {shifted.data_ptr() % 16} bytes past "
            f"a 16-byte boundary: bit-equal to the aligned call")

        xo, xd, out, ct, w, rest = k3_case(torch, L, 3, bf16)
        n = xo.numel() // 240
        assert_no_sync(torch, f"{label} grid_tail_bwd at {n} rows",
                       lambda: gk.grid_tail_bwd(xo, xd, out, ct, w, scale))
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (xo, xd, w, rest)]
        y = gk.grid_tail(*leaves, scale)
        assert_no_sync(torch, f"GridTail backward ({label}) at {n} rows",
                       lambda: torch.autograd.grad(y, leaves, ct))
        del leaves, y

        if not bf16:
            # GridTail (K2 forward, K3 backward) against autograd of the
            # plain forward, on the card, at tests/test_fused_tails.py's
            # tolerance (the bf16 form rounds where JAX's gradient does,
            # not where torch's autograd of its forward would)
            g = torch.Generator().manual_seed(3)
            small = (2, 3, 4, 4, 10)
            args = [t.cuda().requires_grad_(True) for t in (
                torch.randn(*small, 8, 30, generator=g),
                torch.randn(*small, 7, 30, generator=g),
                torch.randn(30, 5, generator=g) * 0.3,
                torch.randn(small[0], 1, *small[2:], 56, 5, generator=g))]
            ct_s = torch.randn(*small, 56, 5, generator=g).cuda()
            grads = torch.autograd.grad(gk.grid_tail(*args, scale), args,
                                        ct_s)
            plain = torch.autograd.grad(gk.grid_tail_plain(*args, scale),
                                        args, ct_s)
            for name, a, b in zip(("xo", "xd", "w", "rest"), grads, plain):
                atol = 1e-5 + 2e-6 * b.abs().max().item()
                if not ((a - b).abs() <= atol + 1e-5 * b.abs()).all():
                    raise AssertionError(f"GridTail d{name}: max |err| "
                                         f"{(a - b).abs().max().item()}")
            log("GridTail on the card: K2+K3 gradients match autograd of "
                "grid_tail_plain (rtol 1e-5, atol 1e-5 + 2e-6 max|grad|)")

        # the wrapper: K3 and the sum of its ct_w partials
        ms = cuda_ms(lambda: gk.grid_tail_bwd(xo, xd, out, ct, w, scale), 20)
        plain_ms = cuda_ms(lambda: gk.grid_tail_bwd_plain(
            xo, xd, out, ct, w, scale), 3, warmup=1)
        b_ms, b_by = k3_bound_ms(n, bf16)
        modes = k3_kernel_ms(torch, (xo, xd, out, ct, w), (0, 1, 2))
        detail = {"share_of_bound": b_ms / ms, "kernel_only_ms": modes[0],
                  "copy_only_ms": modes[1], "compute_only_ms": modes[2]}
        log(f"{label} at {n} rows: {ms:.4f} ms with the ct_w sum (bound "
            f"{b_ms:.4f} ms by {b_by}: {b_ms / ms:.1%} of the bound); "
            f"kernel alone {modes[0]:.4f} ms, copy only {modes[1]:.4f} ms, "
            f"compute only {modes[2]:.4f} ms")
        del xo, xd, out, ct, w, rest
        torch.cuda.empty_cache()
        # the training step's shapes: batch-1 with 2 and 4 channels, batch-6
        for lead in ((1, 2, 128, 4, 10), (1, 4, 128, 4, 10),
                     (6, 4, 128, 4, 10)):
            case = k3_case(torch, lead, 5, bf16)
            rows = case[0].numel() // 240
            t = cuda_ms_cold(lambda: gk.grid_tail_bwd(*case[:5], scale), 20)
            bound, _ = k3_bound_ms(rows, bf16)
            detail[f"ms_{rows}_rows"] = t
            detail[f"bound_ms_{rows}_rows"] = bound
            log(f"{label} at {rows} rows, cold L2: {t:.4f} ms (bound "
                f"{bound:.4f} ms)")
            del case
        entries.append(dict(
            name="grid_tail_bwd_bf16" if bf16 else "grid_tail_bwd",
            route="cuda", source="mst_torch/csrc/grid_tail_bwd.cu",
            replaces="mst_tpu/ops/pallas_grid.py:234", max_abs_err=max_err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, detail=detail))
    return entries


def bf16_edge_values(torch, shape, g, large=True):
    """bf16 values of ``shape`` (rows on the first axis): half from a list
    of edge cases (+-0, bf16 subnormals, the smallest normal, and values
    whose sums fall exactly halfway between two bf16 values: 1 + 2**-8 and
    1 + 3 * 2**-8), half random normals scaled by powers of two from 2**-140
    to 4 (their products with bf16(0.01) round, some on ties). With
    ``large``, every eighth row draws from +-1e30, +-100 and normals scaled
    up to 2**40 instead (its outputs saturate, so the others are kept
    small)."""
    t = 2.0 ** -8
    edges = torch.tensor([0.0, -0.0, 2.0 ** -133, -2.0 ** -133,
                          3 * 2.0 ** -133, -5 * 2.0 ** -133, 2.0 ** -127,
                          2.0 ** -126, -2.0 ** -126, 0.5, -0.5, 1.0, -1.0,
                          t, -t, 3 * t, -3 * t, 1 + 2 ** -7])
    big = torch.tensor([1e30, -1e30, 100.0, -100.0])
    pick = edges[torch.randint(0, len(edges), shape, generator=g)]
    scaled = torch.randn(shape, generator=g) * torch.exp2(
        torch.randint(-140, 3, shape, generator=g).float())
    x = torch.where(torch.rand(shape, generator=g) < 0.5, pick, scaled)
    if large:
        rows = x.reshape(-1, *shape[-2:])
        huge = torch.where(
            torch.rand(rows[::8].shape, generator=g) < 0.5,
            big[torch.randint(0, len(big), rows[::8].shape, generator=g)],
            torch.randn(rows[::8].shape, generator=g) * torch.exp2(
                torch.randint(0, 41, rows[::8].shape, generator=g).float()))
        rows[::8] = huge
    return x.to(torch.bfloat16)


def phase_tail_edges(torch):
    """The bf16 forms of K2 and K3 on edge values (``bf16_edge_values``),
    bit for bit against their plain versions (K3's ct_w within
    ``K3_W_RTOL``). Inputs and outputs hold no NaN, so bits decide, the
    sign of every zero included."""
    from mst_torch.ops import grid_kernel as gk

    g = torch.Generator().manual_seed(6)
    lead = (1, 4, 16, 4, 10)
    n = 4 * 16 * 4 * 10
    xo = bf16_edge_values(torch, lead + (8, 30), g).cuda()
    xd = bf16_edge_values(torch, lead + (7, 30), g).cuda()
    w = (torch.randn(30, 5, generator=g) * 0.3).cuda()
    rest = torch.randn(1, 1, 16, 4, 10, 56, 5, generator=g).cuda()
    ct = bf16_edge_values(torch, lead + (56, 5), g, large=False).cuda()

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    out = gk.grid_tail_fwd(xo, xd, w, rest, K3_SCALE)
    want = gk.grid_tail_plain(xo, xd, w, rest, K3_SCALE)
    torch.cuda.synchronize()
    n_diff = int((bits(out) != bits(want)).sum())
    n_zero = int((xo == 0).sum() + (xd == 0).sum())
    n_sub = int(((xo != 0) & (xo.abs() < 2.0 ** -126)).sum()
                + ((xd != 0) & (xd.abs() < 2.0 ** -126)).sum())
    # the grid's sums LR(xo) + LR(xd) whose fp32 value falls exactly
    # halfway between two bf16 values
    gp = (gk._leaky(xo).float()[..., :, None, :]
          + gk._leaky(xd).float()[..., None, :, :])
    n_ties = int(((gp.view(torch.int32) & 0xFFFF) == 0x8000).sum())
    del gp
    log(f"K2 bf16 edge values ({n} rows; {n_zero} zero and {n_sub} subnormal "
        f"embedding values, {n_ties} grid sums on a bf16 tie): {n_diff} of "
        f"{out.numel()} output bits differ")
    if n_diff or torch.isnan(want).any():
        raise AssertionError("K2 bf16 edge values: not bit-equal")
    got = gk.grid_tail_bwd(xo, xd, out, ct, w, K3_SCALE)
    want = gk.grid_tail_bwd_plain(xo, xd, out, ct, w, K3_SCALE)
    torch.cuda.synchronize()
    for name, a, b in zip(("ct_xo", "ct_xd", "ct_y", "ct_w"), got, want):
        if not torch.isfinite(b).all():
            raise AssertionError(f"K3 bf16 edge values {name}: not finite")
        if name == "ct_w":
            err = (a - b).abs().max().item()
            tol = K3_W_RTOL * b.abs().max().item()
            log(f"K3 bf16 edge values ct_w: max |err| {err:.3g} (tolerance "
                f"{tol:.3g})")
            if not err <= tol:
                raise AssertionError("K3 bf16 edge values ct_w beyond the "
                                     "tolerance")
            continue
        n_diff = int((bits(a) != bits(b)).sum())
        log(f"K3 bf16 edge values {name}: {n_diff} of {a.numel()} value bits "
            f"differ ({int((b == 0).sum())} zeros)")
        if n_diff:
            raise AssertionError(f"K3 bf16 edge values {name}: not bit-equal")


def check_outputs(written, label, styled_notes=True):
    """Every file parses; with ``styled_notes`` every styled one has notes
    (demo params may write silent ones)."""
    from mst_torch.io import smf
    for path in written:
        with open(path, "rb") as fh:
            data = smf.parse_midi_bytes(fh.read())
        styled = "style).mid" in os.path.basename(path)
        n_on = sum(int((t.type == smf.EV_NOTE_ON).sum()) for t in data.tracks)
        if styled_notes and styled and n_on == 0:
            raise AssertionError(f"{label}: styled output has no notes: "
                                 f"{path}")
    log(f"{label}: {len(written)} files parse"
        + ("; every styled output has notes" if styled_notes else ""))


def note_on_events(path):
    """The (time, channel, key, velocity) of every note-on of a file."""
    from mst_torch.io import smf
    with open(path, "rb") as fh:
        data = smf.parse_midi_bytes(fh.read())
    events = []
    for track in data.tracks:
        t = track.delta.cumsum()
        on = track.type == smf.EV_NOTE_ON
        events += zip(t[on].tolist(), track.channel[on].tolist(),
                      track.a[on].tolist(), track.b[on].tolist())
    return events


def differing_share(paths_a, paths_b):
    """(note-on events of a pair of file sets that have no exact match in
    the other set, all of their note-on events)."""
    from collections import Counter
    differ = total = 0
    for a, b in zip(paths_a, paths_b):
        ea, eb = Counter(note_on_events(a)), Counter(note_on_events(b))
        differ += sum(((ea - eb) + (eb - ea)).values())
        total += sum(ea.values()) + sum(eb.values())
    return differ, total


def phase_main(torch, bundle, comps, styles, tmp):
    from mst_torch.parity import midi_differences
    from mst_torch.transfer import ModelBundle, transfer_styles

    out = os.path.join(tmp, "warm")
    t0 = time.perf_counter()
    transfer_styles(bundle, comps, styles, out)
    torch.cuda.synchronize()
    log(f"main path warm-up: {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    written = transfer_styles(bundle, comps, styles,
                              os.path.join(tmp, "gpu"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_jobs = len(comps) * (1 + len(styles))
    log(f"main path: {len(comps)} compositions x {len(styles)} styles "
        f"({n_jobs} jobs) in {wall:.3f} s per request, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    for name in ("raster", "grid_tail"):
        if launches[name] == 0:
            raise AssertionError(f"main path launched no {name} kernel")
    check_outputs(written, "main path")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transfer_styles(bundle, comps, styles, os.path.join(tmp, "prof"))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel events carry the device time; their CPU-side ops repeat it
    busy_us = device_busy_us(events)
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

    # the same request with bf16 extraction: K1 writes bf16 rasters, the
    # apply stage stays at fp32 storage
    bf16 = ModelBundle.from_npz(device="cuda",
                                extract_storage_dtype="bfloat16")
    transfer_styles(bf16, comps, styles, os.path.join(tmp, "bf16_warm"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    written_bf16 = transfer_styles(bf16, comps, styles,
                                   os.path.join(tmp, "bf16"))
    torch.cuda.synchronize()
    wall_bf16 = time.perf_counter() - t0
    launches_bf16 = read_launches()
    log(f"bf16 extraction: {n_jobs} jobs in {wall_bf16:.3f} s per request "
        f"(fp32 extraction {wall:.3f} s), launches {launches_bf16}")
    want = {"raster_bf16": 2, "raster": 0, "grid_tail": 1,
            "grid_tail_bf16": 0}
    for name, count in want.items():
        if launches_bf16[name] != count:
            raise AssertionError(f"bf16 extraction launched {name} "
                                 f"{launches_bf16[name]} times, want {count}")
    check_outputs(written_bf16, "bf16 extraction")
    styled = [(a, b) for a, b in zip(written, written_bf16)
              if "style).mid" in a or "(reconstructed)" in a]
    differ, total = differing_share(*zip(*styled))
    log(f"bf16 extraction vs fp32: {differ} of {total} note-on events of the "
        f"{len(styled)} reconstructed and styled files differ "
        f"({differ / max(total, 1):.2%})")
    del bf16
    return launches, launches_bf16


def mid_files(root):
    """Every .mid under ``root``, by its path relative to ``root``."""
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names
                  if n.endswith(".mid"))


def run_batch_cli(comps, styles, out, *source):
    """``batch-style-transfer-torch.py`` on the card in a process of its
    own. Returns (its printed paths, its wall time in s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "batch-style-transfer-torch.py"),
         "--compositions", *comps, "--styles", *styles, "--out", out,
         "--device", "cuda", *source], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"batch CLI {source or '(demo params)'} exited "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    return proc.stdout.splitlines(), wall


def phase_serve_eval(torch, bundle, comps, styles, tmp):
    """Phase 9: the batch CLI against the in-process request of phase 5,
    extract_style + apply_styles against the same job of that request,
    and transfer_and_evaluate on the card against CPU scoring. Returns
    the launches of the apply and the eval runs."""
    from mst_torch import audio, weights
    from mst_torch.exceptions import MidiFormatError
    from mst_torch.io import load_midi_from_file
    from mst_torch.parity import midi_differences
    from mst_torch.transfer import (
        apply_styles, combine_info, extract_style, get_model_input,
        transfer_and_evaluate)

    request = os.path.join(tmp, "gpu")      # phase 5's 12-job request
    want = mid_files(request)

    def same_bytes(a, b):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()

    out = os.path.join(tmp, "cli")
    printed, wall = run_batch_cli(comps, styles, out, "--weights",
                                  weights.SNAPSHOT_NPZ)
    got = sorted(os.path.relpath(p, out) for p in printed)
    if got != want or mid_files(out) != want:
        raise AssertionError(f"batch CLI wrote {got}, the request {want}")
    differ = [p for p in want if not same_bytes(os.path.join(out, p),
                                                os.path.join(request, p))]
    log(f"batch CLI (--weights, {len(comps)} x {len(styles)}): {wall:.3f} s "
        f"wall in its own process; {len(printed)} paths, the request's set; "
        f"{len(want) - len(differ)} of {len(want)} files byte-equal")
    if differ:
        raise AssertionError(f"batch CLI files differ from the request: "
                             f"{differ}")
    demo = os.path.join(tmp, "cli_demo")
    printed, wall = run_batch_cli(comps, styles, demo)
    if len(printed) != len(want):
        raise AssertionError(f"batch CLI (demo params) wrote {printed}")
    check_outputs(printed, "batch CLI (demo params, seed 0)",
                  styled_notes=False)
    log(f"batch CLI (demo params): {wall:.3f} s wall")

    # one composition and one style through extract_style + apply_styles
    comp, style = (get_model_input(p)[1] for p in (comps[0], styles[0]))
    name = os.path.splitext(os.path.basename(comps[0]))[0]
    style_name = os.path.splitext(os.path.basename(styles[0]))[0]
    job = os.path.join(name, f"{name} ({style_name} style).mid")
    path = os.path.join(tmp, "apply", job)
    reset_launches()
    style_c, melody, rhythm, n_bars = extract_style(bundle, comp)
    style_s = extract_style(bundle, style)[0]
    apply_styles(bundle, [combine_info(style_info=style.info,
                                       melody_info=comp.info)],
                 [style_s], [melody], [rhythm], [len(style.instruments)],
                 [path], [n_bars])
    apply_launches = read_launches()
    log(f"extract_style + apply_styles ({job}): launches {apply_launches}")
    for kernel in ("raster", "grid_tail"):
        if apply_launches[kernel] == 0:
            raise AssertionError(f"extract_style + apply_styles launched no "
                                 f"{kernel} kernel")
    # phase 5's 1 x 1 request buckets the job's latents as extract_style
    # does (Rb 96); the 12-job request pads them to its longest song's
    # bucket (Rb 128), which sums in other orders: held to the
    # fp32-boundary rule
    if not same_bytes(path, os.path.join(tmp, "pair_gpu", job)):
        raise AssertionError(f"apply_styles: {job} differs from the 1 x 1 "
                             f"request's")
    with open(path, "rb") as fa, open(os.path.join(request, job), "rb") as fb:
        equal, faults, borderline = midi_differences(fa.read(), fb.read())
    if faults:
        raise AssertionError(f"apply_styles against the 12-job request: "
                             f"{faults}")
    log(f"apply_styles: {job} byte-equal to the 1 x 1 request's; against "
        f"the 12-job request's: "
        + ("byte-equal" if equal else
           f"{len(borderline)} fp32-boundary note events"))

    # transfer_and_evaluate on the card, the audio stage timed apart
    audio_s = [0.0]
    score_on_card = audio.spectral_similarity_midi

    def timed_score(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return score_on_card(*args, **kwargs)
        finally:
            audio_s[0] += time.perf_counter() - t0

    eval_out = os.path.join(tmp, "eval")
    reset_launches()
    audio.spectral_similarity_midi = timed_score
    try:
        t0 = time.perf_counter()
        scores = transfer_and_evaluate(bundle, comps[0], styles, eval_out)
        wall = time.perf_counter() - t0
    finally:
        audio.spectral_similarity_midi = score_on_card
    eval_launches = read_launches()
    log(f"transfer_and_evaluate (1 x {len(styles)}): {wall:.3f} s wall, "
        f"scoring (render on the host + log-mel on the card) "
        f"{audio_s[0]:.3f} s ({audio_s[0] / wall:.1%}), launches "
        f"{eval_launches}")
    for kernel in ("raster", "grid_tail"):
        if eval_launches[kernel] == 0:
            raise AssertionError(f"transfer_and_evaluate launched no "
                                 f"{kernel} kernel")
    generated = [p for p in mid_files(eval_out)
                 if "original" not in p.split(os.sep)[:-1]]
    if sorted(os.path.relpath(p, eval_out) for p in scores) != generated:
        raise AssertionError(f"scores for {sorted(scores)}, files "
                             f"{generated}")
    comp_data = load_midi_from_file(comps[0])
    style_data = {os.path.splitext(os.path.basename(p))[0]:
                  load_midi_from_file(p) for p in styles}
    def cpu_score(a, b):
        try:
            return audio.spectral_similarity_midi(a, b, device="cpu")
        except MidiFormatError:          # as transfer_and_evaluate scores
            return None

    gap = 0.0
    for path, entry in scores.items():
        data = load_midi_from_file(path)
        for key, score in entry.items():
            if key == "vs_composition":
                ref = comp_data
            else:
                ref = next(d for n, d in style_data.items()
                           if f"({n} style)" in os.path.basename(path))
            cpu = cpu_score(ref, data)
            if (score is None) != (cpu is None):
                raise AssertionError(f"{path} {key}: card {score}, CPU {cpu}")
            if score is None:
                log(f"  {os.path.basename(path)} {key}: silent, no score")
                continue
            if not -1.0 <= score <= 1.0:
                raise AssertionError(f"{path} {key}: score {score}")
            gap = max(gap, abs(score - cpu))
            log(f"  {os.path.basename(path)} {key}: card {score:.7f}, "
                f"CPU {cpu:.7f}")
    log(f"transfer_and_evaluate: {len(scores)} files scored; largest "
        f"card-CPU gap {gap:.3e} (limit {EVAL_ATOL:.0e})")
    if gap > EVAL_ATOL:
        raise AssertionError(f"card scores differ from the CPU's by {gap}")
    # one score's two stages apart: synthesis on the host, log-mel on the
    # card
    t0 = time.perf_counter()
    pcm = [audio.render_midi(d) for d in (comp_data, data)]
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    audio.spectral_similarity(*pcm, device=bundle.device)   # a float
    log(f"one score ({os.path.basename(path)} against {name}): synthesis "
        f"{render_s:.3f} s on the host ({len(pcm[0]) + len(pcm[1])} "
        f"samples), log-mel similarity {time.perf_counter() - t0:.4f} s "
        f"on {bundle.device.type}")
    return apply_launches, eval_launches


def _loss_names(has_unpitched):
    from mst_torch.ops.losses import LossDict
    return [n for n in LossDict._fields
            if has_unpitched or not n.startswith("unpitched")]


def _check_losses(vec, has_unpitched, label):
    """Every loss of the step finite (the unpitched ones only with
    percussion, which is NaN by definition without it)."""
    from mst_torch.ops.losses import LossDict
    values = dict(zip(LossDict._fields, vec.tolist()))
    bad = {k: values[k] for k in _loss_names(has_unpitched)
           if not math.isfinite(values[k])}
    if bad:
        raise AssertionError(f"{label}: non-finite losses {bad}")


def phase_train(torch, paths, tmp, bf16=False):
    """The training path at full width: 8 batch-1 micro-steps, then 2
    batch-6 steps, with the launch counters at 0 first; with ``bf16``
    under bf16 storage and bf16 compute. Returns (the launches of the run,
    its summary for the other run's comparison)."""
    from torch.profiler import ProfilerActivity, profile

    from mst_torch.config import Config, ModelConfig
    from mst_torch.runtime import train as tr
    from mst_torch.runtime.checkpoint import CheckpointManager
    from mst_torch.transfer import get_model_input

    tr.reproducible_backends()        # as train-model-torch.py runs
    policy = (dict(storage_dtype="bfloat16", compute_dtype="bfloat16")
              if bf16 else {})
    config = Config(model=ModelConfig(**policy))
    label = "bf16 training path" if bf16 else "training path"
    t = config.train
    raster_dtype = config.model.storage_dtype
    songs = [get_model_input(p)[1] for p in paths]

    def single(song, device):
        """A batch-1 step's batch, bucketed as train-model-torch.py does."""
        cap = t.max_total_bars // song.n_channels
        Cb = tr.bucket_shape(song.n_channels, t.channel_buckets)
        Rb = tr.bucket_shape(min(song.n_bars, cap), t.bar_buckets)
        return tr.device_batch_from_songs([song], Cb, Rb,
                                          bar_cap=[min(cap, Rb)],
                                          device=device,
                                          raster_dtype=raster_dtype)

    def group(device):
        caps = [t.max_total_bars // s.n_channels for s in songs]
        Cb = tr.bucket_shape(max(s.n_channels for s in songs),
                             t.channel_buckets)
        Rb = tr.bucket_shape(max(min(s.n_bars, c)
                                 for s, c in zip(songs, caps)), t.bar_buckets)
        Rb = tr.clamp_bar_bucket(Rb, len(songs), Cb, songs[0].beats_per_bar,
                                 t.batch_cell_budget, t.bar_buckets)
        return tr.device_batch_from_songs(songs, Cb, Rb,
                                          bar_cap=[min(c, Rb) for c in caps],
                                          device=device,
                                          raster_dtype=raster_dtype)

    plan = [("batch-1", lambda d, i=i: single(songs[i % len(songs)], d))
            for i in range(8)] + [("batch-6", group)] * 2
    steps = {}

    def run_step(state, build, device):
        batch = build(device)
        has_u = batch.unpitched is not None
        if has_u not in steps:
            steps[has_u] = tr.make_train_step(config, has_u)
        state, vec = steps[has_u](state, batch)
        return vec, has_u

    state = tr.create_train_state(config, device="cuda", seed=108)
    n_params = sum(p.numel() for p in state.model.parameters())
    ckpt = CheckpointManager(os.path.join(tmp, "train_ckpt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses, first_grads = [], [], None
    busy_us = prof_wall = None
    t_run = time.perf_counter()
    for i, (kind, build) in enumerate(plan):
        if i == 7:       # the last batch-1 micro-step runs under the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                vec, has_u = run_step(state, build, "cuda")
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            busy_us = device_busy_us(prof.key_averages())
        else:
            t0 = time.perf_counter()
            vec, has_u = run_step(state, build, "cuda")
            torch.cuda.synchronize()
            times.append((kind, time.perf_counter() - t0))
        losses.append((vec, has_u))
        if i == 0:      # iter_size 2: the first step's gradient is unapplied
            first_grads = {n: p.grad.detach().cpu().clone()
                           for n, p in state.model.named_parameters()
                           if p.grad is not None}
        if state.micro_step == 4:
            ckpt.save(4, state, cursor=4)
    run_wall = time.perf_counter() - t_run
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # each kernel of the run's form launches; the other form's never do
    for name, count in launches.items():
        if name.endswith("_bf16") == bf16 and count == 0:
            raise AssertionError(f"{label} launched no {name} kernel")
        if name.endswith("_bf16") != bf16 and count != 0:
            raise AssertionError(f"{label} launched {name} {count} times")
    for i, (vec, has_u) in enumerate(losses):
        _check_losses(vec.cpu(), has_u, f"{label} step {i + 1}")
    if (state.micro_step, state.opt_step) != (10, 5):
        raise AssertionError(f"counters {state.micro_step}, "
                             f"{state.opt_step} after 10 micro-steps")
    b1 = [dt for kind, dt in times[2:] if kind == "batch-1"]
    b6 = [dt for kind, dt in times if kind == "batch-6"]
    summary = dict(b1_ms=sum(b1) / len(b1) * 1e3, b6_ms=[dt * 1e3
                                                          for dt in b6],
                   busy=busy_us / 1e3 / (prof_wall * 1e3), peak_gib=peak)
    log(f"{label}: {n_params} parameters, 10 micro-steps in "
        f"{run_wall:.3f} s, launches {launches}, peak device memory "
        f"{peak:.2f} GiB")
    log(f"  ms per batch-1 step after 2 warm-up steps: "
        f"{[round(dt * 1e3, 3) for dt in b1]}, mean "
        f"{sum(b1) / len(b1) * 1e3:.3f}")
    log(f"  ms per batch-6 step: first {b6[0] * 1e3:.3f}, second "
        f"{b6[1] * 1e3:.3f}")
    log(f"  losses per step (total): "
        f"{[round(v[0].item(), 6) for v, _ in losses]}")
    log(f"  profiled batch-1 step: device busy {busy_us / 1e3:.3f} ms of "
        f"{prof_wall * 1e3:.3f} ms wall ({busy_us / 1e3 / (prof_wall * 1e3):.1%})")
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=12, max_name_column_width=60))

    # the first step on the CPU, from the same seed and the same song
    t0 = time.perf_counter()
    cpu_state = tr.create_train_state(config, device="cpu", seed=108)
    cpu_vec, has_u = run_step(cpu_state, plan[0][1], "cpu")
    log(f"{label}: first step on the CPU: {time.perf_counter() - t0:.3f} s")
    gpu_vec = losses[0][0].cpu()
    from mst_torch.ops.losses import LossDict
    pick = [LossDict._fields.index(n) for n in _loss_names(has_u)]
    diff = (gpu_vec[pick] - cpu_vec[pick]).abs()
    rel = (diff / cpu_vec[pick].abs().clamp(min=1e-12)).max().item()
    if bf16:
        rtol, atol = TRAIN_BF16_LOSS_TOL
        ok = bool((diff <= rtol * cpu_vec[pick].abs() + atol).all())
        loss_tol = f"rtol {rtol}, atol {atol}; max |diff| {diff.max():.3g}"
        grad_tol = TRAIN_BF16_GRAD_TOL
    else:
        ok = rel <= TRAIN_LOSS_RTOL
        loss_tol, grad_tol = f"{TRAIN_LOSS_RTOL} relative", TRAIN_GRAD_TOL
    log(f"{label}: first step GPU vs CPU losses: max relative difference "
        f"{rel:.3g} ({loss_tol})")
    if not ok:
        raise AssertionError(f"{label}: first step GPU vs CPU losses beyond "
                             f"the tolerance")
    worst = (0.0, "")
    for name, p in cpu_state.model.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        got = first_grads.get(name, torch.zeros_like(want))
        err = (got - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        worst = max(worst, (err, name))
    log(f"{label}: first step GPU vs CPU per-leaf gradients within "
        f"{worst[0]:.3g} of each leaf's largest |grad| (worst {worst[1]}, "
        f"tolerance {grad_tol})")
    if not worst[0] <= grad_tol:
        raise AssertionError(f"{label}: first step GPU vs CPU gradient "
                             f"{worst[1]} beyond the tolerance")
    if bf16:
        return launches, summary

    # resume from the save after step 4: step 5's losses again
    resumed = tr.create_train_state(config, device="cuda", seed=0)
    ckpt.restore(resumed, 4)
    vec5, _ = run_step(resumed, plan[4][1], "cuda")
    want5 = losses[4][0]
    rel5 = ((vec5 - want5).abs() / want5.abs().clamp(min=1e-12))
    rel5 = rel5[torch.isfinite(want5)].max().item()
    if not rel5 <= RESUME_RTOL:
        raise AssertionError(f"resume: step 5 losses differ by {rel5} > "
                             f"{RESUME_RTOL}")
    log(f"resume from the save after step 4: step 5 losses within {rel5:.3g} "
        f"relative ({'bit-equal' if torch.equal(vec5, want5) else 'not bit-equal'}"
        f", tolerance {RESUME_RTOL})")
    return launches, summary


def phase_remat(torch, paths):
    """One bf16 micro-step (bf16 storage and compute) with ``remat``
    against the same step without, from the same seed on the same song:
    the CUDA autograd engine runs the recompute on its device thread, which
    must enter the step's policy itself. Losses and gradients must be
    bit-equal (the recompute runs the same kernels on the same inputs; cuDNN
    is deterministic). The remat step runs with the launch counters at 0
    first; returns its launches."""
    from mst_torch.config import Config, ModelConfig, TrainConfig
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    song = get_model_input(paths[0])[1]
    model = ModelConfig(storage_dtype="bfloat16", compute_dtype="bfloat16")
    results = {}
    for remat in (False, True):
        config = Config(model=model, train=TrainConfig(remat=remat))
        t = config.train
        state = tr.create_train_state(config, device="cuda", seed=108)
        torch.cuda.synchronize()
        reset_launches()
        cap = t.max_total_bars // song.n_channels
        Rb = tr.bucket_shape(min(song.n_bars, cap), t.bar_buckets)
        batch = tr.device_batch_from_songs(
            [song], tr.bucket_shape(song.n_channels, t.channel_buckets), Rb,
            bar_cap=[min(cap, Rb)], device="cuda", raster_dtype="bfloat16")
        has_u = batch.unpitched is not None
        _, vec = tr.make_train_step(config, has_u)(state, batch)
        torch.cuda.synchronize()
        launches = read_launches()
        grads = {n: p.grad.detach().clone()
                 for n, p in state.model.named_parameters()
                 if p.grad is not None}
        results[remat] = (vec, grads, launches)
    (vec_a, grads_a, _), (vec_b, grads_b, launches) = (results[False],
                                                       results[True])
    # the bf16 tails launch (K2 twice: the forward and its recompute); no
    # fp32 form does
    for name, count in launches.items():
        bad = count == 0 if name.endswith("_bf16") else count != 0
        if bad:
            raise AssertionError(f"bf16 remat step launched {name} {count} "
                                 f"times")
    same_losses = torch.equal(vec_a.view(torch.int32),
                              vec_b.view(torch.int32))
    differ = [n for n in grads_a if n not in grads_b
              or not torch.equal(grads_a[n], grads_b[n])]
    log(f"bf16 remat step (launches {launches}): losses "
        f"{'bit-equal' if same_losses else 'differ'} to the step without "
        f"remat, {len(grads_a) - len(differ)} of {len(grads_a)} gradient "
        f"leaves bit-equal")
    if not same_losses or differ or grads_a.keys() != grads_b.keys():
        raise AssertionError(f"bf16 remat step differs from the plain step "
                             f"(leaves {differ[:5]})")
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
    kernels = phase_k1(torch, bundle, songs) + phase_k2(torch)
    with tempfile.TemporaryDirectory() as tmp:
        serve, serve_bf16 = phase_main(torch, bundle, comps, styles, tmp)
        apply_run, eval_run = phase_serve_eval(torch, bundle, comps, styles,
                                               tmp)
        del bundle
        torch.cuda.empty_cache()
        kernels += phase_k3(torch)
        phase_tail_edges(torch)
        torch.cuda.empty_cache()
        train, fp32 = phase_train(torch, comps + styles, tmp)
        torch.cuda.empty_cache()
        train_bf16, bf16 = phase_train(torch, comps + styles, tmp, bf16=True)
        remat = phase_remat(torch, comps + styles)
    log(f"training, bf16 storage and compute against fp32 (one call): "
        f"batch-1 step {bf16['b1_ms']:.3f} ms against {fp32['b1_ms']:.3f}; "
        f"batch-6 steps {[round(v, 3) for v in bf16['b6_ms']]} against "
        f"{[round(v, 3) for v in fp32['b6_ms']]} ms; device busy "
        f"{bf16['busy']:.1%} against {fp32['busy']:.1%}; peak memory "
        f"{bf16['peak_gib']:.2f} against {fp32['peak_gib']:.2f} GiB")
    for k in kernels:
        name = k["name"]
        by_path = {"transfer request": serve[name],
                   "transfer request, bf16 extraction": serve_bf16[name],
                   "extract_style + apply_styles": apply_run[name],
                   "transfer_and_evaluate": eval_run[name],
                   "10 training micro-steps": train[name],
                   "10 bf16-storage training micro-steps": train_bf16[name],
                   "bf16 remat micro-step": remat[name]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}), launches {by_path}")
    ms = {k["name"]: k["ms"] for k in kernels}
    for label, name in (("K2", "grid_tail"), ("K3", "grid_tail_bwd")):
        log(f"{label} bf16 against fp32 (one call): "
            f"{ms[name + '_bf16']:.4f} ms against {ms[name]:.4f} ms "
            f"({ms[name + '_bf16'] / ms[name]:.3f}x)")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "detail")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
