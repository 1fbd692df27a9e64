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
   weights on 3 compositions x 3 styles (12 jobs) on ``cuda``, its programs
   uncaptured (``capture=False``; phase 14 captures them), once to warm
   up and once with every launch counter at 0, which must see K1 and K2
   launch. Every output parses and every styled output has notes. Two more
   requests run under ``runtime.metrics.profiler_trace`` with the model's
   components annotated (``runtime.profile.model_scopes``), the first as
   the tracer's warm-up, out of the trace: the second's device-busy time
   (``runtime.profile.summarize``) beside its wall time; its trace is kept
   for phase 13, which splits it.
   Then 1 composition x 1 style runs
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
   ``make_train_step`` (Adam with a ``LambdaLR`` over
   ``make_lr_schedule``, iter_size 2), with every launch
   counter at 0 first; each of K1, K2 and K3 must launch and every loss
   must be finite. Three more batch-1 micro-steps run from the run's
   state under ``runtime.metrics.profiler_trace`` and ``model_scopes``:
   one that warms the tracer up, then a traced pair on the songs of steps
   1 and 2 (the first applies Adam), for phases 12 and 13. It prints the
   ms per step after warm-up, the pair's device-busy share
   (``runtime.profile.summarize``) and the peak memory. The first
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
10. Training over ranks (mst_torch.parallel), with the kernels already
   built by phase 1 so that no rank builds them. A one-rank NCCL group:
   one full-width data-parallel micro-step must give the plain step's
   losses and gradients bit for bit. Then two gloo ranks in processes of
   their own share the card (a FileStore, a timeout on the group and on
   the join), each holding one smoke song of a global batch of two: each
   rank's raster (K1 on its song alone) must equal its slice of the whole
   batch's raster bit for bit, in fp32 and bf16; two full-width
   micro-steps and one apply (iter_size 2), with the launch counters at 0
   first, must launch K1 twice, K2 once and K3 once a micro-step on each
   rank; rank 0's losses and accumulated gradients must match the
   one-process batch-2 step on the card (``TRAIN_LOSS_RTOL``,
   ``TRAIN_GRAD_TOL``), and both ranks' parameters after the apply must
   be bit-equal. The sequence-parallel recurrence
   (mst_torch.parallel.seq_lstm) on the two ranks, the relay at B = 1 and
   the pipeline at B = 8 (128 bars, H = 128), forward and w_hh gradient,
   against the dense ``_recur`` on the card: bit-equal, or within
   ``SEQ_RTOL`` where cuBLAS picks another algorithm for B/2 rows than for
   B (the count of differing values is printed). It prints the 2-rank
   micro-step's wall time beside the one-process batch-2 step's.
11. The bar-sharded model (``--seq-parallel``, mst_torch.ops.seq_context):
   two gloo ranks in processes of their own share the card as a (1 data x
   2 seq) mesh, each holding bars 0-63 or 64-127 of a global batch of
   comp_0 (capped at 40 bars, so its last bar lies on rank 0) and style_0
   (its last bar on rank 1), Cb 4, Rb 128 (40,960 raster rows, 20,480 a
   rank), at full width from the seed-108 init. Each rank's fp32 and
   bf16 rasters (K1 on the notes of its bars alone) must equal its bars
   of the one-process rasters bit for bit; K2 and K3 on its bars of
   random tail inputs at that shape, in both forms, must give the
   matching rows of the one-process launch bit for bit (K2's output, K3's
   ct_xo, ct_xd, ct_y and ct_rest), and the two ranks' ct_w partials must
   add up to the one-process ct_w within ``K3_W_RTOL``. Two micro-steps
   and one apply, with the launch counters at 0 first, must launch K1
   twice, K2 once and K3 once a micro-step on each rank; rank 0's losses
   and accumulated gradients must match the one-process batch-2 step
   (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_TOL``), both ranks must hold the
   same losses, and their parameters after the apply must be bit-equal.
   It prints the micro-step's wall time beside the one-process step's.
12. FLOP accounting (mst_torch.runtime.flops): the matmul FLOPs of work
   the earlier phases run, counted on the card's route (K1, K2 and K3
   launched; backwards on the CUDA autograd engine's thread) and on the
   CPU's (the plain versions), must be equal integers: the 1 x 1 request
   of phase 5 (one more card run, counted; the CPU run of phase 5,
   counted), the first batch-1 micro-step of phase 7 and the first of
   phase 8 (bf16) against their CPU twins, which those phases run counted.
   It prints each count with the card's name and power limit, and its MFU
   against the card's peak for the compute dtype over the wall time and
   over the device time of the traces of phases 5, 7 and 8 (``summarize``),
   for the 12-job request (counted in one more run) and for the batch-1
   steps (steps 1 and 2 are counted; step 7 runs step 1's song, timed, and
   the traced pair runs both songs).
13. The profile tools (mst_torch.runtime.profile, tools/*_torch.py):
   ``summarize`` of the traces of phases 5 (the 12-job request) and 7
   (the micro-step pair), each per request or micro-step: every child of
   the model must have device time under ``[fwd]`` (in the micro-step,
   under ``[fwd]`` and ``[bwd]``), the share of ``other`` must stay under
   ``OTHER_SHARE_MAX``, the K1, K2 and K3 launches must be the path's
   (request: 2, 1, 0; micro-step: 2, 1, 1; phases 5, 7 and 8 take a
   trace again, up to 3 in all, when the tracer lost the device record of
   a launch, and log each loss), and the sum over its
   components and the sum over its kernel categories must each equal its
   busy time within 0.1% (this holds by construction: it guards the
   summary's bookkeeping, not the attribution). It prints the top 5
   categories, the 5 longest idle gaps with the host ops across them, and
   the matmul share of the fp32 peak with phase 12's counts. Then
   ``tools/profile_transfer_torch.py`` runs the smoke request stage by
   stage on the card (one warm-up, 3 rounds): its stages must sum to
   within 10% of its staged round's wall time, and every file it writes
   must equal phase 5's request's byte for byte. It prints the time of
   phases 7's and 8's checkpoint saves (``StageTimer``).
14. The captured serving programs (mst_torch.runtime.programs): phases
   2-13 run the transfer programs uncaptured (``capture=False``); here a
   bundle captures them as CUDA graphs. Requests run until one captures
   nothing (each capture's program key, warm-up and capture time are
   printed); one replayed request, counters at 0 first, must launch K1
   twice and K2 once (the counts a capture recorded, added on each
   replay) and capture nothing. Five replayed requests and five of the same
   programs uncaptured, in turns: the median and spread of each one's wall
   time. The files of both must equal phase 5's request's byte for byte,
   or within the fp32-boundary rule with the count of boundary events
   printed. The launch of one replay (input copies, replay, output copy)
   runs under ``torch.cuda.set_sync_debug_mode("error")``; its fetch
   does not. One replayed request, after a replayed warm-up under the
   tracer, is traced: its device records must hold K1 twice and K2 once
   by kernel name, equal to the counters; it prints the device-busy time
   and share and the host's launch calls beside phase 5's uncaptured
   request's. A request whose first capacity tier is 1024 must escalate
   through the ladder to the request's own tier, and one with a starved
   pool hint (a 16-record tier) must run again at its exact tier; both
   write phase 5's files. A bundle with
   ``extract_storage_dtype="bfloat16"`` captures its programs, launches
   K1's bf16 form twice in a replay and writes phase 5's bf16 request's
   files. It prints the graphs held and the peak device memory.

15. The captured training step (mst_torch.runtime.train on
   mst_torch.runtime.programs): phases 7-11 run the step eagerly
   (``capture=False``); here, from the seed-108 init on the smoke songs,
   a captured state and an eager one take the same calls in turns, and
   after every call their losses, and after every apply their parameters,
   gradient buffers and Adam moments, must be bit-equal (or within
   ``CAPTURE_RTOL``, the gap printed): 10 batch-1 micro-steps with the
   rate decaying every 2 applies, in fp32 and under the bf16 policies; 3
   bf16 ``remat`` micro-steps on one song; 3 ``k=2`` stacks. Every
   captured call, counters at 0 first, must launch K2 and K3 once a
   micro-step (K2 twice under remat: the recompute) and K1 never (the
   batch is built before). It prints the ms per call, replayed, eager and
   first calls (the real step and its capture), median and min-max; each
   graph's capture cost; the graphs held; the peak memory; and, for a
   traced replayed fp32 pair, the device-busy share and the host's launch
   calls beside phase 7's eager pair. It checks that ``LambdaLR`` fills
   Adam's tensor rate in place. ``train-model-torch.py --iters 12``,
   captured and ``--no-capture``, must write the same CSV rows, and a
   captured ``--resume`` to 16 must repeat the uninterrupted run's rows.
   Phase 14's bundle replays one request with its ``call_log`` on:
   ``replay_log_flops`` of the log must equal phase 12's count of the
   request.
16. Serving over a device mesh (``ModelBundle(mesh=...)``, mst_torch.
   parallel.create_device_mesh): every visible card up to 4 when there
   are two or more, else two shards on cuda:0 (a log line says which).
   On two or more cards K1, K2 and K3, in both forms, first launch on
   every card against their plain versions at phase 4's shapes (each card
   sets the kernels' shared-memory limit itself); on one card a log line
   says this has nothing to show. The 12-job request captured over the
   mesh: requests until one captures nothing; one replay, counters at 0,
   must launch K1 twice and K2 once on each shard (taken around each
   shard's own program calls) and write phase 14's replayed files byte
   for byte, or with every fp32-boundary cell listed; the same request
   uncaptured must write the replay's files bit for bit; with
   ``extract_storage_dtype="bfloat16"`` K1's bf16 form must launch twice a
   shard and the files meet phase 5's bf16 request's. Six replayed mesh
   requests and six single-card replays, in turns, each bundle first in
   every other turn: median and spread. A
   traced replay: device busy (summed over the cards), K launches by
   kernel name (2 K1 and 1 K2 a shard), host launch calls. Each card's
   graphs, which must be captured on a stream of that card. The call log
   of a replayed mesh request: ``replay_log_flops`` against phase 12's
   count, equal unless pad rows explain the difference (then named).

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
import warnings

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
# the sequence-parallel recurrence against the dense scan on the card,
# relative to the largest |value|: the same operations, but the pipeline's
# products have B/2 rows where the dense scan's have B, and cuBLAS may
# pick another algorithm (another summation order) for them
SEQ_RTOL = 1e-5
# phase 13: component and category sums against busy time (they hold by
# construction: each kernel gets one label of each kind)
PROFILE_SUM_RTOL = 1e-3
# phase 13: the most of a trace's busy time that may fall outside every
# model component, `other [fwd|bwd]` (measured 17.9% for the request and
# 6.2% for a micro-step on an H100; a broken host-device or forward-backward
# link puts most kernels there)
OTHER_SHARE_MAX = {"request": 0.25, "micro-step": 0.10}
STAGE_SUM_RTOL = 0.1      # phase 13: stages' sum vs the staged wall time
TRACE_TAKES = 3           # traces of a run, until one has every device record
RANK_TIMEOUT = 600        # seconds the phase-10 and 11 ranks may take
# phase 15: a replayed training step against the same step eager, relative
# to the largest |value| of each loss vector and state tensor: the graph
# holds the eager step's kernels on the same inputs, so bit-equal is
# expected; any gap is printed with this bound
CAPTURE_RTOL = 1e-6
SEQ_CAPS = (40, 128)      # phase 11: comp_0 ends on seq rank 0, style_0 on 1
SEQ_CB, SEQ_RB = 4, 128
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


def complete_trace(label, take):
    """``take()`` traces a run and returns (its ``summarize``, the traced
    run's wall seconds). Now and then the tracer loses the device record of
    a launch the trace holds (``unrecorded_launches``; PERF.md §7), and the
    summary then misses that kernel's time and launch. Such a trace is
    logged and taken again, up to TRACE_TAKES in all; the checks read only
    a trace with every device record."""
    for attempt in range(1, TRACE_TAKES + 1):
        summary, wall = take()
        lost = summary["unrecorded_launches"]
        if not lost:
            return summary, wall
        log(f"{label}: the tracer lost the device records of {lost} "
            f"(trace {attempt} of at most {TRACE_TAKES})")
    raise AssertionError(f"{label}: the tracer lost device records in "
                         f"{TRACE_TAKES} traces in a row, the last {lost}")


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
    return smi


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

    inputs, statics, _ = _extract_inputs(bundle, songs, 4, True)
    B, Cb, Rb, T = (statics[k] for k in ("B", "Cb", "Rb", "T"))
    p_notes, u_notes = (tuple(t.cuda() for t in notes)
                        for notes in inputs[:2])
    cases = [("pitched", p_notes, B * Cb * Rb * T * 10, 56, 5),
             ("unpitched", u_notes, B * Rb * T * 10, 47, 2)]
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
    _, _, per_sm, rows = gk.bwd_launch_info(0, xo.dtype)
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
        smem, threads, per_sm, rows_per_tile = gk.bwd_launch_info(
            0, dtype)
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
    from mst_torch.runtime.flops import MatmulFlops, device_peak_flops
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

    from mst_torch.runtime.metrics import profiler_trace
    from mst_torch.runtime.profile import model_scopes, summarize

    # phase 12's counts: the 12-job request and the 1 x 1 request on the
    # card, each in a run of its own (counting slows the run it counts)
    counts = {"wall_s": wall, "dir": os.path.join(tmp, "gpu"),
              "children": [n for n, _ in bundle.model.named_children()]}
    with MatmulFlops() as count:
        transfer_styles(bundle, comps, styles, os.path.join(tmp, "counted"))
    counts["request"] = count.total

    # a warm-up request under the tracer, out of the trace (a kernel's first
    # launch after the tracer starts can lose its device record), then the
    # profiled one; phase 13 reads the trace
    trace = os.path.join(tmp, "trace_request")

    def take():
        with profiler_trace(trace) as end_warmup, \
                model_scopes(bundle.model):
            transfer_styles(bundle, comps, styles,
                            os.path.join(tmp, "prof_warm"))
            torch.cuda.synchronize()
            end_warmup()
            t0 = time.perf_counter()
            transfer_styles(bundle, comps, styles, os.path.join(tmp, "prof"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return summarize(trace, 1, flops=count.total,
                         peak_flops=device_peak_flops("float32"),
                         device="cuda"), wall

    t_trace = time.perf_counter()
    counts["summary"], prof_wall = complete_trace("profiled request", take)
    counts["trace_s"] = time.perf_counter() - t_trace - prof_wall
    counts["busy_s"] = counts["summary"]["busy_ms_per_step"] / 1e3
    log(f"profiled request: device busy {counts['busy_s'] * 1e3:.3f} ms of "
        f"{prof_wall * 1e3:.3f} ms wall (phase 13 splits it)")
    with MatmulFlops() as count:
        transfer_styles(bundle, comps[:1], styles[:1],
                        os.path.join(tmp, "pair_counted"))
    counts["pair_gpu"] = count.total

    # one composition x one style on the card and on the CPU
    gpu = transfer_styles(bundle, comps[:1], styles[:1],
                          os.path.join(tmp, "pair_gpu"))
    t0 = time.perf_counter()
    with MatmulFlops() as count:
        cpu = transfer_styles(ModelBundle.from_npz(device="cpu"), comps[:1],
                              styles[:1], os.path.join(tmp, "pair_cpu"))
    counts["pair_cpu"] = count.total
    log(f"1 x 1 on the CPU (its matmul FLOPs counted): "
        f"{time.perf_counter() - t0:.3f} s")
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
    bf16 = ModelBundle.from_npz(device="cuda", capture=False,
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
    return launches, launches_bf16, counts


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


def group_batch(tr, songs, t, device, raster_dtype="float32", mesh=None):
    """One training step's batch of ``songs``, bucketed and capped as
    train-model-torch.py does for ``--batch-size len(songs)``."""
    caps = [t.max_total_bars // s.n_channels for s in songs]
    Cb = tr.bucket_shape(max(s.n_channels for s in songs), t.channel_buckets)
    Rb = tr.bucket_shape(max(min(s.n_bars, c) for s, c in zip(songs, caps)),
                         t.bar_buckets)
    Rb = tr.clamp_bar_bucket(Rb, len(songs), Cb, songs[0].beats_per_bar,
                             t.batch_cell_budget, t.bar_buckets)
    return tr.device_batch_from_songs(songs, Cb, Rb,
                                      bar_cap=[min(c, Rb) for c in caps],
                                      device=device,
                                      raster_dtype=raster_dtype, mesh=mesh)


def phase_train(torch, paths, tmp, bf16=False):
    """The training path at full width: 8 batch-1 micro-steps, then 2
    batch-6 steps, with the launch counters at 0 first; with ``bf16``
    under bf16 storage and bf16 compute. Returns (the launches of the run,
    its summary for the other run's comparison)."""
    from mst_torch.config import Config, ModelConfig
    from mst_torch.runtime import train as tr
    from mst_torch.runtime.checkpoint import CheckpointManager
    from mst_torch.runtime.flops import MatmulFlops, device_peak_flops
    from mst_torch.runtime.metrics import StepTimer, profiler_trace
    from mst_torch.runtime.profile import StageTimer, model_scopes, summarize
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
        return group_batch(tr, songs, t, device, raster_dtype)

    plan = [("batch-1", lambda d, i=i: single(songs[i % len(songs)], d))
            for i in range(8)] + [("batch-6", group)] * 2
    steps = {}

    def run_step(state, build, device):
        batch = build(device)
        has_u = batch.unpitched is not None
        if has_u not in steps:
            steps[has_u] = tr.make_train_step(config, has_u, capture=False)
        state, vec = steps[has_u](state, batch)
        return vec, has_u

    state = tr.create_train_state(config, device="cuda", seed=108)
    n_params = sum(p.numel() for p in state.model.parameters())
    ckpt = CheckpointManager(os.path.join(tmp, "train_ckpt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # batch-1 steps 1-8 (the first two a warm-up, out of the mean), the two
    # batch-6 steps
    timers = {"batch-1": StepTimer(warmup=2, device="cuda"),
              "batch-6": StepTimer(warmup=0, device="cuda")}
    save_timer = StageTimer("cuda")       # phase 13 prints the save's time
    losses, first_grads, counted = [], None, []
    t_run = time.perf_counter()
    for i, (kind, build) in enumerate(plan):
        if i < 2:      # the warm-up steps are counted (phase 12)
            with timers[kind], MatmulFlops() as count:
                vec, has_u = run_step(state, build, "cuda")
            counted.append(count.total)
        else:
            with timers[kind]:
                vec, has_u = run_step(state, build, "cuda")
        losses.append((vec, has_u))
        if i == 0:      # iter_size 2: the first step's gradient is unapplied
            first_grads = {n: p.grad.detach().cpu().clone()
                           for n, p in state.model.named_parameters()
                           if p.grad is not None}
        if state.micro_step == 4:
            with save_timer("checkpoint save"):
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
    b1_timer = timers["batch-1"]
    b1, b6 = b1_timer.times[b1_timer.warmup:], timers["batch-6"].times

    # a traced pair of batch-1 micro-steps from this state, on the songs of
    # the counted steps 1 and 2 (the first applies Adam), after one on the
    # first song that warms the tracer up; phases 12 and 13 read it
    pair_trace = os.path.join(tmp, "trace_pair_bf16" if bf16
                              else "trace_pair")
    def take():
        with profiler_trace(pair_trace) as end_warmup, \
                model_scopes(state.model):
            run_step(state, plan[0][1], "cuda")      # the tracer's warm-up
            torch.cuda.synchronize()
            end_warmup()
            t0 = time.perf_counter()
            for _, build in plan[:2]:
                run_step(state, build, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return summarize(
            pair_trace, 2, flops=counted[0] + counted[1],
            peak_flops=device_peak_flops(config.model.compute_dtype),
            device="cuda"), wall

    t_pair = time.perf_counter()
    pair, pair_wall = complete_trace(f"{label}: traced pair", take)
    busy_ms = pair["busy_ms_per_step"] * 2
    summary = dict(b1_ms=b1_timer.mean * 1e3, b6_ms=[dt * 1e3 for dt in b6],
                   busy=busy_ms / (pair_wall * 1e3), peak_gib=peak,
                   # phase 12: step 7 runs the song of the counted step 1;
                   # the pair, those of steps 1 and 2
                   flops=counted, step7_s=b1_timer.times[6],
                   pair=pair, pair_busy_s=busy_ms / 1e3,
                   pair_s=time.perf_counter() - t_pair,
                   children=[n for n, _ in state.model.named_children()],
                   save_ms=save_timer.times["checkpoint save"] * 1e3,
                   compute_dtype=config.model.compute_dtype)
    log(f"{label}: {n_params} parameters, 10 micro-steps in "
        f"{run_wall:.3f} s, launches {launches}, peak device memory "
        f"{peak:.2f} GiB")
    log(f"  ms per batch-1 step after 2 warm-up steps: "
        f"{[round(dt * 1e3, 3) for dt in b1]}, mean "
        f"{b1_timer.mean * 1e3:.3f}")
    log(f"  ms per batch-6 step: first {b6[0] * 1e3:.3f}, second "
        f"{b6[1] * 1e3:.3f}")
    log(f"  losses per step (total): "
        f"{[round(v[0].item(), 6) for v, _ in losses]}")
    log(f"  traced pair of batch-1 steps: device busy {busy_ms:.3f} ms of "
        f"{pair_wall * 1e3:.3f} ms wall ({summary['busy']:.1%})")

    # the first step on the CPU, from the same seed and the same song
    t0 = time.perf_counter()
    cpu_state = tr.create_train_state(config, device="cpu", seed=108)
    with MatmulFlops() as count:
        cpu_vec, has_u = run_step(cpu_state, plan[0][1], "cpu")
    summary["cpu_flops"] = count.total
    log(f"{label}: first step on the CPU (its matmul FLOPs counted): "
        f"{time.perf_counter() - t0:.3f} s")
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
        _, vec = tr.make_train_step(config, has_u, capture=False)(state,
                                                                  batch)
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


def _bit_equal(torch, got, want):
    ints = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(torch.equal(got.view(ints), want.view(ints))))


def _rel_err(got, want):
    """Largest |got - want| over the largest |want|."""
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


def _first_step(torch, state, vec):
    return vec.detach().cpu(), {n: p.grad.detach().cpu().clone()
                                for n, p in state.model.named_parameters()
                                if p.grad is not None}


def _seq_cases(torch, mesh, dev):
    """Phase 10's sequence-parallel recurrence on this rank's half of 128
    bars, H = 128, against the dense ``_recur`` of the whole sequence on
    the card: (largest relative error, values that differ, values) of the
    outputs, the gates' gradient and the w_hh gradient, relay and
    pipeline."""
    from mst_torch.ops.lstm import _recur
    from mst_torch.parallel.seq_lstm import seq_sharded_scan

    n, T, H = mesh.shape["seq"], 128, 128
    t_l = T // n
    mine = slice(mesh.seq_index * t_l, (mesh.seq_index + 1) * t_l)
    out = {}
    for label, B in (("relay B=1", 1), ("pipeline B=8", 8)):
        g = torch.Generator().manual_seed(B)
        gates = torch.randn(B, T, 4 * H, generator=g).to(dev)
        w = (torch.randn(H, 4 * H, generator=g) * 0.1).to(dev)
        ct = torch.randn(B, T, H, generator=g).to(dev)
        gl = gates[:, mine].clone().requires_grad_()
        wl = w.clone().requires_grad_()
        got = seq_sharded_scan(gl, wl, mesh)
        (got * ct[:, mine]).sum().backward()
        gd, wd = gates.clone().requires_grad_(), w.clone().requires_grad_()
        want = _recur(gd[None], wd[None])[0]
        (want * ct).sum().backward()
        out[label] = {
            name: (_rel_err(a, b), int((a != b).sum().item()), a.numel())
            for name, a, b in (("outputs", got.detach(), want[:, mine]),
                               ("gates grad", gl.grad, gd.grad[:, mine]),
                               ("w_hh grad", wl.grad, wd.grad))}
    return out


def parallel_rank(rank, world, store, out, paths):
    """One gloo rank of phase 10, in a process of its own on card 0: the
    per-rank rasters, two data-parallel micro-steps with the launch
    counters on, and the sequence-parallel recurrence. Saves what it
    measured to ``out``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from mst_torch.config import Config
    from mst_torch.parallel import (create_mesh, initialize_multihost,
                                    make_sharded_train_step, replicate)
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    os.environ["LOCAL_RANK"] = str(rank)    # as a launcher sets it
    tr.reproducible_backends()
    initialize_multihost("file://" + store, world, rank, backend="gloo",
                         timeout=RANK_TIMEOUT / 2)
    try:
        config = Config()
        t = config.train
        songs = [get_model_input(p)[1] for p in paths]
        # the trainer's way to its card: LOCAL_RANK modulo the cards, made
        # the current device (cuda:0 for both ranks on one card)
        mesh = create_mesh(n_data=world)
        dev = mesh.device
        if torch.cuda.current_device() != dev.index:
            raise AssertionError(f"rank {rank}: current device "
                                 f"{torch.cuda.current_device()}, mesh "
                                 f"device {dev}")
        rows = mesh.data_rows(len(songs))
        rasters = {}
        for dtype in ("float32", "bfloat16"):
            dense = group_batch(tr, songs, t, dev, dtype)
            mine = group_batch(tr, songs, t, dev, dtype, mesh)
            rasters[dtype] = all(
                _bit_equal(torch, getattr(mine, f), getattr(dense, f)[rows])
                for f in ("pitched", "unpitched"))
        state = replicate(tr.create_train_state(config, device=dev,
                                                seed=108), mesh)
        torch.cuda.synchronize()
        reset_launches()
        walls, losses, first = [], [], None
        for i in range(2):
            t0 = time.perf_counter()
            batch = group_batch(tr, songs, t, dev, mesh=mesh)
            step = make_sharded_train_step(config, batch.unpitched is not None,
                                           mesh)
            _, vec = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(vec.cpu())
            if i == 0:
                first = _first_step(torch, state, vec)
        launches = read_launches()
        params = {n: p.detach().cpu() for n, p in
                  state.model.named_parameters()}
        seq = _seq_cases(torch, create_mesh(n_data=1, n_seq=world,
                                            device=dev), dev)
        torch.save(dict(rasters=rasters, walls=walls, losses=losses,
                        first=first, launches=launches, params=params,
                        opt_step=state.opt_step, seq=seq),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_parallel(torch, paths, tmp, smi):
    """Phase 10: training over ranks (module docstring). Returns rank 0's
    launches of the two data-parallel micro-steps."""
    import torch.distributed as dist

    from mst_torch.config import Config
    from mst_torch.ops.losses import LossDict
    from mst_torch.parallel import create_mesh, initialize_multihost
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    tr.reproducible_backends()
    config = Config()
    t = config.train
    songs = [get_model_input(p)[1] for p in paths]

    # one rank under NCCL: the data-parallel step is the plain step
    initialize_multihost("file://" + os.path.join(tmp, "nccl_store"), 1, 0,
                         backend="nccl", timeout=RANK_TIMEOUT / 2)
    try:
        mesh = create_mesh(n_data=1, device="cuda:0")
        runs, walls = {}, []
        for label, m in (("plain", None), ("one-rank", mesh)):
            state = tr.create_train_state(config, device="cuda", seed=108)
            for i in range(2 if m is None else 1):
                t0 = time.perf_counter()
                batch = group_batch(tr, songs, t, "cuda", mesh=m)
                _, vec = tr.make_train_step(
                    config, batch.unpitched is not None, mesh=m,
                    capture=False)(state, batch)
                torch.cuda.synchronize()
                if m is None:
                    walls.append(time.perf_counter() - t0)
                if i == 0:
                    runs[label] = _first_step(torch, state, vec)
    finally:
        dist.destroy_process_group()
    (vec_a, grads_a), (vec_b, grads_b) = runs["plain"], runs["one-rank"]
    same = _bit_equal(torch, vec_b, vec_a) and grads_a.keys() == \
        grads_b.keys() and all(_bit_equal(torch, grads_b[n], grads_a[n])
                               for n in grads_a)
    log(f"phase 10: one-rank NCCL data-parallel micro-step against the "
        f"plain step: {'bit-equal' if same else 'DIFFERS'} (losses and "
        f"{len(grads_a)} gradient leaves)")
    if not same:
        raise AssertionError("the one-rank data-parallel step differs from "
                             "the plain step")

    # two gloo ranks on the card, one song each
    ranks, seconds = _run_rank_processes(parallel_rank, 2, tmp, "ranks",
                                         paths)
    log(f"phase 10: 2 gloo ranks ran in {seconds:.3f} s "
        f"(process start included)")

    for r, rec in enumerate(ranks):
        for dtype, ok in rec["rasters"].items():
            log(f"  rank {r}: its {dtype} rasters against its rows of the "
                f"one-process rasters: {'bit-equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"rank {r}'s {dtype} raster differs")
        want = {"raster": 4, "grid_tail": 2, "grid_tail_bwd": 2}
        got = rec["launches"]
        log(f"  rank {r}: launches over 2 micro-steps {got}")
        if any(got[k] != want.get(k, 0) for k in got):
            raise AssertionError(f"rank {r} launched {got}, want K1 2, K2 1 "
                                 f"and K3 1 a micro-step")
        if rec["opt_step"] != 1:
            raise AssertionError(f"rank {r}: {rec['opt_step']} applies")
    differ = [n for n, q in ranks[0]["params"].items()
              if not _bit_equal(torch, ranks[1]["params"][n], q)]
    log(f"  parameters after the apply: {len(ranks[0]['params']) - len(differ)}"
        f" of {len(ranks[0]['params'])} leaves bit-equal across the ranks")
    if differ:
        raise AssertionError(f"parameters differ across ranks: {differ[:5]}")
    for rec in ranks[1:]:
        if not torch.equal(rec["losses"][0], ranks[0]["losses"][0]):
            raise AssertionError("the ranks' losses differ")

    # rank 0's first micro-step against the one-process batch-2 step
    vec, grads = ranks[0]["first"]
    finite = torch.isfinite(vec_a)
    loss_err = ((vec - vec_a).abs()[finite]
                / vec_a.abs()[finite].clamp(min=1e-12)).max().item()
    worst = max((_rel_err(grads[n], grads_a[n]), n) for n in grads_a)
    log(f"  rank 0 against the one-process batch-2 step: losses within "
        f"{loss_err:.3g} relative (tolerance {TRAIN_LOSS_RTOL}), gradients "
        f"within {worst[0]:.3g} of each leaf's largest |grad| (worst "
        f"{worst[1]}, tolerance {TRAIN_GRAD_TOL}); total "
        f"{vec[LossDict._fields.index('total')].item():.6f}")
    if not (loss_err <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_GRAD_TOL
            and grads.keys() == grads_a.keys()):
        raise AssertionError("rank 0's step is beyond the tolerance of the "
                             "one-process step")

    for label, fields in ranks[0]["seq"].items():
        for name, (err, n_diff, n) in fields.items():
            # each rank holds a chunk of the outputs and of the gates'
            # gradient, and the whole w_hh gradient
            held = ranks if name != "w_hh grad" else ranks[:1]
            worst_err = max(rec["seq"][label][name][0] for rec in ranks)
            diffs = sum(rec["seq"][label][name][1] for rec in held)
            log(f"  seq_sharded_scan {label} {name} against the dense "
                f"_recur: largest relative error {worst_err:.3g}, {diffs} of "
                f"{n * len(held)} values differ (tolerance {SEQ_RTOL})")
            if not worst_err <= SEQ_RTOL:
                raise AssertionError(f"seq_sharded_scan {label} {name} "
                                     f"beyond the tolerance")
    walls_dp = ranks[0]["walls"]
    log(f"phase 10 times ({smi}): 2-rank data-parallel micro-step "
        f"(gloo, both ranks on the one card, one song each) "
        f"{[round(w * 1e3, 3) for w in walls_dp]} ms; one-process batch-2 "
        f"micro-step {[round(w * 1e3, 3) for w in walls]} ms")
    return ranks[0]["launches"]


def seq_batch(tr, songs, device, raster_dtype="float32", mesh=None):
    """Phase 11's global batch (comp_0 and style_0 at ``SEQ_CB`` channels,
    ``SEQ_RB`` bars, capped at ``SEQ_CAPS``), or a rank's share of it."""
    return tr.device_batch_from_songs(songs, SEQ_CB, SEQ_RB,
                                      bar_cap=list(SEQ_CAPS), device=device,
                                      raster_dtype=raster_dtype, mesh=mesh)


def _seq_tails(torch, bars):
    """K2 and K3 on this rank's bars of random tail inputs at phase 11's
    shape, in both forms, against the rows of the one-process launch:
    {form: (row outputs bit-equal, this rank's ct_w partial, the
    one-process ct_w)}."""
    from mst_torch.ops import grid_kernel as gk

    lead = (len(SEQ_CAPS), SEQ_CB, SEQ_RB, 4, 10)
    out = {}
    for bf16 in (False, True):
        xo, xd, y, ct, w, rest = k3_case(torch, lead, 11, bf16=bf16)
        full = gk.grid_tail_bwd(xo, xd, y, ct, w, K3_SCALE)
        mine = [t[:, :, bars].contiguous() for t in (xo, xd, y, ct, rest)]
        y_l = gk.grid_tail_fwd(mine[0], mine[1], w, mine[4], K3_SCALE)
        local = gk.grid_tail_bwd(mine[0], mine[1], mine[2], mine[3], w,
                                 K3_SCALE)
        rows = [_bit_equal(torch, y_l, y[:, :, bars])]
        rows += [_bit_equal(torch, a, b[:, :, bars])
                 for a, b in zip(local[:3], full[:3])]
        rows.append(_bit_equal(torch, local[2].sum(1, keepdim=True),
                               full[2].sum(1, keepdim=True)[:, :, bars]))
        out["bf16" if bf16 else "fp32"] = (all(rows), local[3].cpu(),
                                           full[3].cpu())
    return out


def seq_rank(rank, world, store, out, paths):
    """One gloo rank of phase 11, in a process of its own on card 0: its
    bars' rasters and tails against the one-process ones, then two
    bar-sharded micro-steps with the launch counters on. Saves what it
    measured to ``out``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from mst_torch.config import Config
    from mst_torch.parallel import (create_mesh, initialize_multihost,
                                    make_sharded_train_step, replicate)
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    os.environ["LOCAL_RANK"] = str(rank)    # as a launcher sets it
    tr.reproducible_backends()
    initialize_multihost("file://" + store, world, rank, backend="gloo",
                         timeout=RANK_TIMEOUT / 2)
    try:
        config = Config()
        songs = [get_model_input(p)[1] for p in paths]
        mesh = create_mesh(n_data=1, n_seq=world)
        dev = mesh.device
        bars = mesh.seq_bars(SEQ_RB)
        rasters = {}
        for dtype in ("float32", "bfloat16"):
            dense = seq_batch(tr, songs, dev, dtype)
            mine = seq_batch(tr, songs, dev, dtype, mesh)
            rasters[dtype] = all(
                _bit_equal(torch, getattr(mine, f),
                           getattr(dense, f)[:, :, bars])
                for f in ("pitched", "unpitched"))
        tails = _seq_tails(torch, bars)
        state = replicate(tr.create_train_state(config, device=dev,
                                                seed=108), mesh)
        torch.cuda.synchronize()
        reset_launches()
        walls, losses, first = [], [], None
        for i in range(2):
            t0 = time.perf_counter()
            batch = seq_batch(tr, songs, dev, mesh=mesh)
            step = make_sharded_train_step(config, batch.unpitched is not None,
                                           mesh)
            _, vec = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(vec.cpu())
            if i == 0:
                first = _first_step(torch, state, vec)
        launches = read_launches()
        params = {n: p.detach().cpu() for n, p in
                  state.model.named_parameters()}
        torch.save(dict(rasters=rasters, tails=tails, walls=walls,
                        losses=losses, first=first, launches=launches,
                        params=params, opt_step=state.opt_step),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_rank_processes(target, world, tmp, name, paths):
    """Spawn ``world`` processes of ``target`` (rank, world, store, out,
    paths) and wait for them under ``RANK_TIMEOUT``; returns what each
    saved and the seconds they took."""
    import multiprocessing

    import torch

    out = os.path.join(tmp, name)
    os.makedirs(out)
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=target,
                           args=(r, world, os.path.join(tmp, name + "_store"),
                                 out, list(paths)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{name}: exit codes "
                             f"{[p.exitcode for p in procs]}"
                             f"{' (killed at the time limit)' if alive else ''}")
    return ([torch.load(os.path.join(out, f"rank{r}.pt"))
             for r in range(world)], time.perf_counter() - t0)


def phase_seq(torch, paths, tmp, smi):
    """Phase 11: the bar-sharded model over two seq ranks (module
    docstring). Returns rank 0's launches of its two micro-steps."""
    from mst_torch.config import Config
    from mst_torch.ops.losses import LossDict
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    tr.reproducible_backends()
    config = Config()
    songs = [get_model_input(p)[1] for p in paths]
    state = tr.create_train_state(config, device="cuda", seed=108)
    walls = []
    for i in range(2):
        t0 = time.perf_counter()
        batch = seq_batch(tr, songs, "cuda")
        _, vec = tr.make_train_step(config, batch.unpitched is not None,
                                    capture=False)(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            vec_a, grads_a = _first_step(torch, state, vec)
    del state
    torch.cuda.empty_cache()

    ranks, seconds = _run_rank_processes(seq_rank, 2, tmp, "seq_ranks",
                                         paths)
    log(f"phase 11: 2 gloo seq ranks ran in {seconds:.3f} s (process start "
        f"included)")
    for r, rec in enumerate(ranks):
        for dtype, ok in rec["rasters"].items():
            log(f"  seq rank {r}: its bars of the {dtype} rasters against "
                f"the one-process rasters: {'bit-equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"seq rank {r}'s {dtype} raster differs")
        for form, (ok, _, _) in rec["tails"].items():
            log(f"  seq rank {r}: {form} K2 output and K3 ct_xo, ct_xd, ct_y "
                f"and ct_rest on its bars against the one-process launch: "
                f"{'bit-equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"seq rank {r}'s {form} tail rows "
                                     f"differ")
        want = {"raster": 4, "grid_tail": 2, "grid_tail_bwd": 2}
        got = rec["launches"]
        log(f"  seq rank {r}: launches over 2 micro-steps {got}")
        if any(got[k] != want.get(k, 0) for k in got):
            raise AssertionError(f"seq rank {r} launched {got}, want K1 2, "
                                 f"K2 1 and K3 1 a micro-step")
        if rec["opt_step"] != 1:
            raise AssertionError(f"seq rank {r}: {rec['opt_step']} applies")
    for form in ("fp32", "bf16"):
        parts = sum(rec["tails"][form][1] for rec in ranks)
        full = ranks[0]["tails"][form][2]
        err = _rel_err(parts, full)
        log(f"  {form} K3 ct_w: the ranks' partials summed against the "
            f"one-process ct_w within {err:.3g} of its largest (tolerance "
            f"{K3_W_RTOL})")
        if not err <= K3_W_RTOL:
            raise AssertionError(f"{form} ct_w over seq ranks beyond "
                                 f"K3_W_RTOL")
    differ = [n for n, q in ranks[0]["params"].items()
              if not _bit_equal(torch, ranks[1]["params"][n], q)]
    log(f"  parameters after the apply: "
        f"{len(ranks[0]['params']) - len(differ)} of "
        f"{len(ranks[0]['params'])} leaves bit-equal across the seq ranks")
    if differ:
        raise AssertionError(f"parameters differ across seq ranks: "
                             f"{differ[:5]}")
    if not all(torch.equal(a, b) for a, b in zip(ranks[1]["losses"],
                                                 ranks[0]["losses"])):
        raise AssertionError("the seq ranks' losses differ")

    vec, grads = ranks[0]["first"]
    finite = torch.isfinite(vec_a)
    loss_err = ((vec - vec_a).abs()[finite]
                / vec_a.abs()[finite].clamp(min=1e-12)).max().item()
    worst = max((_rel_err(grads[n], grads_a[n]), n) for n in grads_a)
    log(f"  seq rank 0 against the one-process batch-2 step: losses within "
        f"{loss_err:.3g} relative (tolerance {TRAIN_LOSS_RTOL}), gradients "
        f"within {worst[0]:.3g} of each leaf's largest |grad| (worst "
        f"{worst[1]}, tolerance {TRAIN_GRAD_TOL}); total "
        f"{vec[LossDict._fields.index('total')].item():.6f}")
    if not (loss_err <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_GRAD_TOL
            and grads.keys() == grads_a.keys()):
        raise AssertionError("seq rank 0's step is beyond the tolerance of "
                             "the one-process step")
    log(f"phase 11 times ({smi}): 2-seq-rank micro-step (gloo, both ranks "
        f"on the one card, 64 bars each) "
        f"{[round(w * 1e3, 3) for w in ranks[0]['walls']]} ms; one-process "
        f"batch-2 micro-step {[round(w * 1e3, 3) for w in walls]} ms")
    return ranks[0]["launches"]


def phase_flops(serve, fp32, bf16, smi):
    """Phase 12: each count of the card's route against the same work's
    count on the CPU's (equal integers, or the run fails), and the MFU of
    each count over the wall and the device time phases 5, 7 and 8
    measured (device time: ``summarize`` of their traces)."""
    from mst_torch.runtime.flops import device_peak_flops

    pairs = [("1 x 1 request", serve["pair_gpu"], serve["pair_cpu"]),
             ("first batch-1 fp32 micro-step", fp32["flops"][0],
              fp32["cpu_flops"]),
             ("first batch-1 bf16 micro-step", bf16["flops"][0],
              bf16["cpu_flops"])]
    for label, gpu, cpu in pairs:
        log(f"phase 12: {label}: {gpu} matmul FLOPs on the card, {cpu} on "
            f"the CPU ({smi})")
        if gpu != cpu or gpu <= 0:
            raise AssertionError(f"FLOP count of the {label}: card {gpu}, "
                                 f"CPU {cpu}")
    rows = [("12-job request", serve["request"], "float32", serve["wall_s"],
             serve["busy_s"])]
    for name, run in (("fp32", fp32), ("bf16", bf16)):
        rows.append((f"batch-1 {name} micro-step (step 1 counted, step 7 "
                     f"timed)", run["flops"][0], run["compute_dtype"],
                     run["step7_s"], None))
        rows.append((f"batch-1 {name} micro-step pair (steps 1 and 2 "
                     f"counted, their songs traced)", sum(run["flops"]),
                     run["compute_dtype"], None, run["pair_busy_s"]))
    for label, n, dtype, wall_s, busy_s in rows:
        peak = device_peak_flops(dtype)
        by = [f"{kind} {seconds * 1e3:.3f} ms: MFU {n / seconds / peak:.4e}"
              for kind, seconds in (("wall", wall_s), ("device", busy_s))
              if seconds is not None]
        log(f"phase 12: {label}: {n} matmul FLOPs ({n:.4e}); peak "
            f"{peak:.4g} FLOP/s ({dtype}); {'; '.join(by)} ({smi})")


def phase_profile(torch, serve, fp32, bf16, comps, styles, tmp, smi):
    """Phase 13: the summaries of phase 5's and phase 7's traces, and the
    stage tool on the smoke request."""
    import importlib.util

    t_phase = time.perf_counter()
    cases = (("12-job request", serve["summary"], serve["children"],
              ("[fwd]",), OTHER_SHARE_MAX["request"],
              {"K1": 2, "K2": 1, "K3": 0}),
             ("batch-1 fp32 micro-step (pair)", fp32["pair"],
              fp32["children"], ("[fwd]", "[bwd]"),
              OTHER_SHARE_MAX["micro-step"], {"K1": 2, "K2": 1, "K3": 1}))
    for label, s, children, phases, other_max, want in cases:
        busy = s["busy_ms_per_step"]
        comps_ms, cats_ms = s["by_component_ms"], s["by_category_ms"]
        got = {k: s["by_category_launches"].get(k, 0) for k in want}
        others = {k: round(v, 3) for k, v in comps_ms.items()
                  if k.startswith("other")}
        other_share = sum(others.values()) / busy
        lost = s["unrecorded_launches"]
        log(f"phase 13: {label}: busy {busy:.3f} ms a step; components sum "
            f"to {sum(comps_ms.values()):.3f}, categories to "
            f"{sum(cats_ms.values()):.3f}; other {others} "
            f"({other_share:.1%}, at most {other_max:.0%}); K launches a "
            f"step {got}; launches without a device record {lost}; "
            f"{s['model_gflops_per_step']:.3f} GFLOPs a step, matmul "
            f"{s['matmul_fraction_of_peak']:.4e} of the fp32 peak by device "
            f"time ({smi})")
        log(f"  components (ms a step): "
            f"{ {k: round(v, 3) for k, v in comps_ms.items()} }")
        log("  top categories (ms a step, share, launches a step): "
            + "; ".join(f"{k} {v:.3f} ({v / busy:.1%}, "
                        f"{s['by_category_launches'][k]:g})"
                        for k, v in list(cats_ms.items())[:5]) + f" ({smi})")
        log(f"  all categories (ms a step): "
            f"{ {k: round(v, 3) for k, v in cats_ms.items()} }")
        for gap in s["idle_gaps"][:5]:
            log(f"  idle gap {gap['ms']:.3f} ms at {gap['at_ms']:.3f} ms: "
                f"host in {gap['host'][-160:]} ({smi})")
        top_ops = list(s["top_ops_ms"].items())[:8]
        log(f"  top ops (ms a step): "
            f"{ {k: round(v, 3) for k, v in top_ops} }")
        for key, values in (("components", comps_ms),
                            ("categories", cats_ms)):
            total = sum(values.values())
            if not abs(total - busy) <= PROFILE_SUM_RTOL * busy:
                raise AssertionError(f"phase 13: {label}: {key} sum to "
                                     f"{total} ms, busy {busy} ms")
        if got != want:
            raise AssertionError(f"phase 13: {label}: K launches {got}, "
                                 f"want {want}; launches without a device "
                                 f"record in the trace: {lost}")
        missing = [f"StyleTransferModel.{name} {phase}" for name in children
                   for phase in phases
                   if f"StyleTransferModel.{name} {phase}" not in comps_ms]
        if missing:
            raise AssertionError(f"phase 13: {label}: no device time in "
                                 f"{missing}")
        if not other_share <= other_max:
            raise AssertionError(f"phase 13: {label}: {other_share:.1%} of "
                                 f"the busy time in no model component "
                                 f"(at most {other_max:.0%})")

    spec = importlib.util.spec_from_file_location(
        "profile_transfer_torch",
        os.path.join(ROOT, "tools", "profile_transfer_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = os.path.join(tmp, "stages")
    result = tool.main(["--device", "cuda", "--rounds", "3", "--out", out,
                        "--compositions", *comps, "--styles", *styles])
    total, staged = result["stage_sum_ms"], result["staged_ms"]
    if not abs(total - staged) <= STAGE_SUM_RTOL * staged:
        raise AssertionError(f"phase 13: stages sum to {total} ms of a "
                             f"{staged} ms staged round")

    def contents(root):
        files = {}
        for name in mid_files(root):
            with open(os.path.join(root, name), "rb") as fh:
                files[name] = fh.read()
        return files

    want_files = contents(serve["dir"])
    for r in range(3):
        if contents(os.path.join(out, f"staged_{r}")) != want_files:
            raise AssertionError(f"phase 13: the stage tool's round {r} "
                                 f"wrote other files than phase 5's request")
    log(f"phase 13: stage tool: stages sum to {total:.3f} of {staged:.3f} "
        f"ms a staged round ({total / staged:.1%}); transfer_styles "
        f"{result['request_ms']:.3f} ms; {len(want_files)} files byte-equal "
        f"to phase 5's request in each of 3 rounds ({smi})")
    log(f"phase 13: checkpoint save after phase 7's step 4 (StageTimer): "
        f"{fp32['save_ms']:.3f} ms fp32, {bf16['save_ms']:.3f} ms under the "
        f"bf16 policies ({smi})")
    phase_s = time.perf_counter() - t_phase
    added = phase_s + fp32["pair_s"] + serve["trace_s"]
    log(f"phase 13: {phase_s:.1f} s, plus {fp32['pair_s']:.1f} s for phase "
        f"7's traced pair and its summary and {serve['trace_s']:.1f} s for "
        f"phase 5's tracer warm-up, scopes, export and summary: "
        f"{added:.1f} s in all (phase 8's traced pair: "
        f"{bf16['pair_s']:.1f} s)")


def host_launches(trace_dir):
    """The host's launch calls in a trace, by name: kernel and graph
    launches, copies and fills (CUDA runtime and driver API calls)."""
    from collections import Counter
    from mst_torch.runtime.profile import LAUNCH_CATS, load_events
    return Counter(e["name"] for e in load_events(trace_dir)
                   if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                   and any(k in e["name"]
                           for k in ("Launch", "Memcpy", "Memset")))


def files_against(root, want_root, label):
    """Every .mid under ``root`` against the same file under ``want_root``:
    byte-equal, or within the fp32-boundary rule (mst_torch.parity), or
    the run fails. Returns (byte-equal files, files, boundary events)."""
    from mst_torch.parity import midi_differences
    names = mid_files(want_root)
    if mid_files(root) != names:
        raise AssertionError(f"{label}: files {mid_files(root)}, want "
                             f"{names}")
    equal = boundary = 0
    for name in names:
        with open(os.path.join(root, name), "rb") as fa, \
                open(os.path.join(want_root, name), "rb") as fb:
            same, faults, borderline = midi_differences(fa.read(), fb.read())
        if faults:
            raise AssertionError(f"{label}: {name}: {faults}")
        equal += same
        boundary += len(borderline)
    return equal, len(names), boundary


def phase_captured(torch, comps, styles, tmp, smi, request_flops):
    """Phase 14: the serving programs captured as CUDA graphs and replayed
    (mst_torch.runtime.programs), on the 12-job request. Returns the
    launches of one replayed request, by kernel form. Then (phase 15's
    ``call_log`` check) one more replayed request with the bundle's call
    log on: ``replay_log_flops`` of it must equal ``request_flops``, phase
    5's count of the request uncaptured."""
    import statistics

    from mst_torch import transfer as tr
    from mst_torch.runtime.metrics import profiler_trace
    from mst_torch.runtime.profile import summarize

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    names = [name for name, _, _ in _counters()]
    bundle = tr.ModelBundle.from_npz(device="cuda")
    eager = tr.ModelBundle.from_npz(device="cuda", capture=False)
    programs = bundle.programs
    want_dir = os.path.join(tmp, "gpu")           # phase 5's request

    def request(b, name):
        t0 = time.perf_counter()
        tr.transfer_styles(b, comps, styles, os.path.join(tmp, name))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def capture(b, label):
        """Requests until one captures nothing: the first request's record
        sums become the pool hint, which may pick another tier."""
        for r in range(3):
            held = len(b.programs.graphs)
            wall = request(b, f"{label}_capture_{r}")
            new = list(b.programs.graphs.values())[held:]
            for g in new:
                log(f"phase 14: {label}: request {r} captured {g.key}: "
                    f"warm-up {g.warmup_s * 1e3:.3f} ms, capture "
                    f"{g.capture_s * 1e3:.3f} ms; a replay launches "
                    f"{dict(zip(names, g.launches))} ({smi})")
            log(f"phase 14: {label}: request {r}: {wall * 1e3:.3f} ms "
                f"wall, {len(new)} programs captured")
            if not new:
                return
        raise AssertionError(f"phase 14: {label}: a third request still "
                             f"captured")

    def counted(b, name, want):
        """One request with the counters at 0; it may capture nothing and
        must launch ``want`` (every other form 0)."""
        held = len(b.programs.graphs)
        reset_launches()
        request(b, name)
        got = read_launches()
        if len(b.programs.graphs) != held or any(
                got[k] != want.get(k, 0) for k in got):
            raise AssertionError(f"phase 14: {name}: launches {got}, want "
                                 f"{want}; graphs {held} -> "
                                 f"{len(b.programs.graphs)}")
        return got

    capture(bundle, "fp32")
    request(eager, "eager_warm")
    launches = counted(bundle, "replay_counted", {"raster": 2,
                                                  "grid_tail": 1})
    log(f"phase 14: one replayed request: launches {launches}")

    held = len(programs.graphs)
    replay_s, eager_s = [], []
    for r in range(5):
        replay_s.append(request(bundle, f"replay_{r}"))
        eager_s.append(request(eager, f"eager_{r}"))
    if len(programs.graphs) != held:
        raise AssertionError("phase 14: a timed request captured a program")

    def spread(v):
        return (f"median {statistics.median(v) * 1e3:.3f} ms (min "
                f"{min(v) * 1e3:.3f}, max {max(v) * 1e3:.3f}; "
                f"{', '.join(f'{t * 1e3:.3f}' for t in v)})")

    log(f"phase 14: 12-job request, captured and replayed: "
        f"{spread(replay_s)}; the same programs uncaptured, in turns: "
        f"{spread(eager_s)} ({smi})")
    for label, name in (("replayed", "replay_4"), ("uncaptured", "eager_4")):
        equal, n, boundary = files_against(os.path.join(tmp, name),
                                           want_dir, f"phase 14 {label}")
        log(f"phase 14: {label} request against phase 5's: {equal} of {n} "
            f"files byte-equal, {boundary} fp32-boundary note events")

    # the launch of one replay may not wait for the card; its fetch does
    checked = []
    run = programs.run

    def run_checked(key, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run(key, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked.append(key)
        return out

    programs.run = run_checked
    try:
        request(bundle, "replay_nosync")
    finally:
        del programs.run
    if not checked or len(programs.graphs) != held:
        raise AssertionError(f"phase 14: the checked request ran {checked}")
    log(f"phase 14: the launch of a replay ({checked}): input copies, "
        f"replay and output copy with no host synchronisation (sync debug "
        f"mode 'error'); the fetch after it waits for the card")

    # one replayed request traced, after a replayed warm-up under the tracer
    trace = os.path.join(tmp, "trace_replay")
    traced = {}

    def take():
        with profiler_trace(trace) as end_warmup:
            request(bundle, "replay_trace_warm")
            end_warmup()
            reset_launches()
            wall = request(bundle, "replay_traced")
            traced["launches"] = read_launches()
        return summarize(trace, 1, device="cuda"), wall

    summary, wall = complete_trace("phase 14 traced replay", take)
    got = {k: summary["by_category_launches"].get(k, 0)
           for k in ("K1", "K2", "K3")}
    n = traced["launches"]
    counters = {"K1": n["raster"] + n["raster_bf16"],
                "K2": n["grid_tail"] + n["grid_tail_bf16"],
                "K3": n["grid_tail_bwd"] + n["grid_tail_bwd_bf16"]}
    if got != counters or got != {"K1": 2, "K2": 1, "K3": 0}:
        raise AssertionError(f"phase 14: the traced replay's device records "
                             f"{got}, the counters {counters}, want K1 2, "
                             f"K2 1, K3 0")
    busy = summary["busy_ms_per_step"]
    host = host_launches(trace)
    eager_host = host_launches(os.path.join(tmp, "trace_request"))
    log(f"phase 14: traced replayed request: device busy {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall ({busy / (wall * 1e3):.1%}); K launches "
        f"by kernel name {got}, equal to the counters; host launch calls "
        f"{sum(host.values())} {dict(host)}; phase 5's uncaptured request: "
        f"{sum(eager_host.values())} ({smi})")
    log("  top categories (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in list(summary["by_category_ms"].items())
        [:6]))

    # the ladder on the card: a small first capacity tier, a starved pool
    def ladder(label, name, patch, hints):
        """One request with ``tr``'s ``patch`` and the bundle's ``hints``
        set; returns the program keys it ran, in order."""
        saved = {k: getattr(tr, k) for k in patch}
        ran = []

        def recording(key, *args, **kwargs):
            ran.append(key)
            return run(key, *args, **kwargs)

        for k, v in patch.items():
            setattr(tr, k, v)
        for k, v in hints.items():
            setattr(bundle, k, v)
        programs.run = recording
        try:
            request(bundle, name)
        finally:
            del programs.run
            for k, v in saved.items():
                setattr(tr, k, v)
        equal, n_files, boundary = files_against(
            os.path.join(tmp, name), want_dir, f"phase 14 {label}")
        log(f"phase 14: {label}: programs run {ran}; capacity hint "
            f"{bundle.capacity_hint}, pool hints {bundle.pool_hint_p}, "
            f"{bundle.pool_hint_u}; {equal} of {n_files} files byte-equal "
            f"to phase 5's, {boundary} fp32-boundary note events")
        return ran

    steady, hint = checked[-1], bundle.capacity_hint
    ran = ladder("first capacity tier 1024", "ladder_tier",
                 {"COMPACT_CAPACITIES": (1024,) + tr.COMPACT_CAPACITIES},
                 {"capacity_hint": 0})
    if len(ran) < 2 or not ran[0].startswith("transfer_fused:1024:") \
            or ran[-1] != steady or bundle.capacity_hint != hint:
        raise AssertionError(f"phase 14: the 1024 tier did not escalate to "
                             f"{steady}: {ran}")
    ran = ladder("starved pool (tier 16)", "ladder_pool",
                 {"POOL_TIERS": (16,) + tr.POOL_TIERS},
                 {"pool_hint_p": 1, "pool_hint_u": 1})
    if len(ran) != 2 or not ran[0].endswith(":pool=16,16") \
            or ran[1] != steady:
        raise AssertionError(f"phase 14: the starved pool did not run again "
                             f"at {steady}: {ran}")

    # bf16 extraction: the policy a capture bakes in
    bf16 = tr.ModelBundle.from_npz(device="cuda",
                                   extract_storage_dtype="bfloat16")
    capture(bf16, "bf16 extraction")
    counted(bf16, "bf16_replay", {"raster_bf16": 2, "grid_tail": 1})
    equal, n_files, boundary = files_against(
        os.path.join(tmp, "bf16_replay"), os.path.join(tmp, "bf16"),
        "phase 14 bf16 extraction")
    log(f"phase 14: bf16-extraction request, replayed, against phase 5's "
        f"uncaptured one: {equal} of {n_files} files byte-equal, {boundary} "
        f"fp32-boundary note events")

    # the call log of a replayed request, replayed uncaptured under the
    # counter: a replay itself shows the counter nothing
    from mst_torch.runtime.flops import replay_log_flops

    held = len(programs.graphs)
    bundle.call_log = calls = []
    request(bundle, "replay_logged")
    bundle.call_log = None
    counted_flops = replay_log_flops(bundle, calls)
    log(f"phase 15: call_log of a replayed 12-job request: "
        f"{[key for key, *_ in calls]}; replay_log_flops {counted_flops} "
        f"matmul FLOPs, phase 12's count of the request uncaptured "
        f"{request_flops}")
    if counted_flops != request_flops or len(programs.graphs) != held:
        raise AssertionError(f"phase 15: replay_log_flops {counted_flops} "
                             f"!= {request_flops}")

    graphs = [g.key for b in (bundle, bf16) for g in b.programs.graphs.values()]
    log(f"phase 14: {len(graphs)} graphs held ({graphs}); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB since "
        f"phase 14 began; phase 14 took {time.perf_counter() - t_phase:.1f} "
        f"s ({smi})")
    return launches


def mesh_devices(torch):
    """Phase 16's mesh: every visible card, up to 4, when there are two or
    more; else two shards on cuda:0."""
    from mst_torch.parallel import create_device_mesh

    n = min(torch.cuda.device_count(), 4)
    if n >= 2:
        return create_device_mesh(n), f"{n} cards, one shard each"
    return (create_device_mesh(2, devices=["cuda:0"] * 2),
            "one card: two shards on cuda:0")


def phase_per_card_kernels(torch, songs):
    """Phase 16, on two or more cards: K1, K2 and K3 in both forms on every
    card against their plain versions, at phase 4's shapes (the smoke
    songs' extraction raster, the 12-job apply, the 327,680-row budget).
    Each card must set the kernels' shared-memory limit itself (K2 fp32
    takes 93,504 B, above the 48 KB default). Returns the cards checked."""
    from mst_torch.ops import grid_kernel as gk
    from mst_torch.ops import raster_kernel as rk
    from mst_torch.transfer import ModelBundle, _extract_inputs

    inputs, statics, _ = _extract_inputs(
        ModelBundle.from_npz(device="cpu"), songs, 4, True)
    B, Cb, Rb, T = (statics[k] for k in ("B", "Cb", "Rb", "T"))
    rows = B * Cb * Rb * T * 10
    scale = (6.0, 1.0, 1.0, 1.0, 1.0)
    cards = list(range(torch.cuda.device_count()))
    for card in cards:
        with torch.cuda.device(card):
            dev = torch.device("cuda", card)
            notes = tuple(t.to(dev) for t in inputs[0])
            for dtype in (torch.float32, torch.bfloat16):
                got = rk.rasterize(*notes, rows, 56, 5, dtype)
                want = rk.segment_rasterize_plain(*notes, rows, 56, 5, dtype)
                torch.cuda.synchronize(dev)
                if got.device != dev or not raster_bits_equal(torch, got,
                                                              want):
                    raise AssertionError(f"phase 16: K1 {dtype} on card "
                                         f"{card}: not bit-equal")
            for bf16 in (False, True):
                xo, xd, w, rest = tail_inputs(torch, (12, 8, 128, 4, 10), 2,
                                              bf16=bf16)
                got = gk.grid_tail_fwd(xo, xd, w, rest, scale)
                want = gk.grid_tail_plain(xo, xd, w, rest, scale)
                err = (got.float() - want.float()).abs().max().item()
                if got.device != dev or not err <= K2_ATOL:
                    raise AssertionError(f"phase 16: K2 bf16={bf16} on card "
                                         f"{card}: max |err| {err}")
                del xo, xd, w, rest, got, want
                xo, xd, out, ct, w, _ = k3_case(torch, (8, 8, 128, 4, 10), 3,
                                                bf16)
                got = gk.grid_tail_bwd(xo, xd, out, ct, w, K3_SCALE)
                want = gk.grid_tail_bwd_plain(xo, xd, out, ct, w, K3_SCALE)
                torch.cuda.synchronize(dev)
                for name, a, c in zip(("ct_xo", "ct_xd", "ct_y", "ct_w"), got,
                                      want):
                    err = (a.float() - c.float()).abs().max().item()
                    tol = ((K3_W_RTOL if name == "ct_w" else K3_RTOL)
                           * c.abs().max().item())
                    if a.device != dev or not err <= tol:
                        raise AssertionError(f"phase 16: K3 bf16={bf16} "
                                             f"{name} on card {card}: max "
                                             f"|err| {err} > {tol}")
                info = gk.bwd_launch_info(card, xo.dtype)
                del xo, xd, out, ct, w, got, want
                log(f"phase 16: card {card}: K1, K2 and K3 "
                    f"({'bf16' if bf16 else 'fp32'}) launched there and "
                    f"agree with their plain versions; K3's launch info "
                    f"there {info}")
        torch.cuda.empty_cache()
    return cards


def phase_mesh(torch, comps, styles, songs, tmp, smi, request_flops):
    """Phase 16: the smoke request over a device mesh
    (``ModelBundle(mesh=create_device_mesh(...))``), captured, eager and
    with bf16 extraction, against phase 14's captured single-card request;
    K1 and K2 launches by shard; its time against the single-card replay
    in turns; graphs per card; host launch calls and busy time of a traced
    replay; ``replay_log_flops`` of its log against phase 12's count.
    Returns the launches of one replayed mesh request, by kernel form."""
    import statistics

    from mst_torch import transfer as tr
    from mst_torch.parity import midi_differences
    from mst_torch.runtime.flops import replay_log_flops
    from mst_torch.runtime.metrics import profiler_trace
    from mst_torch.runtime.profile import summarize

    t_phase = time.perf_counter()
    mesh, layout = mesh_devices(torch)
    n = mesh.shape["data"]
    log(f"phase 16: mesh {mesh.shape} over {list(mesh.devices)} ({layout})")
    if torch.cuda.device_count() >= 2:
        cards = phase_per_card_kernels(torch, songs)
        log(f"phase 16: the per-card launch setup (K2's and K3's "
            f"shared-memory limit set on each card; each card's programs "
            f"captured on a stream of that card) holds on cards {cards}")
    else:
        log("phase 16: one card: the per-card launch setup (shared-memory "
            "limits, capture streams) has nothing to show here; it shows "
            "only with two or more cards")
    names = [name for name, _, _ in _counters()]
    mesh_b = tr.ModelBundle.from_npz(mesh=mesh)
    single = tr.ModelBundle.from_npz(device="cuda")
    want_dir = os.path.join(tmp, "replay_4")      # phase 14's replay

    def programs_of(b):
        return list({id(b.replica(s)[2]): b.replica(s)[2]
                     for s in range(b.data_axis_size())}.values())

    def graphs_of(b):
        return [g for p in programs_of(b) for g in p.graphs.values()]

    def request(b, name):
        t0 = time.perf_counter()
        tr.transfer_styles(b, comps, styles, os.path.join(tmp, name))
        for dev in dict.fromkeys(b.shard_devices):
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def capture(b, label):
        for r in range(3):
            held = len(graphs_of(b))
            wall = request(b, f"{label}_capture_{r}")
            new = graphs_of(b)[held:]
            for g in new:
                log(f"phase 16: {label}: request {r} captured {g.key}: "
                    f"warm-up {g.warmup_s * 1e3:.3f} ms, capture "
                    f"{g.capture_s * 1e3:.3f} ms; a replay launches "
                    f"{dict(zip(names, g.launches))}")
            if not new:
                return
        raise AssertionError(f"phase 16: {label}: a third request still "
                             f"captured")

    def by_shard(b, name):
        """One request with the counters at 0 and each shard's launches
        taken around its own program calls; it may capture nothing."""
        held = len(graphs_of(b))
        run = b.run
        shards = [dict.fromkeys(names, 0) for _ in range(n)]

        def counted(key, inputs, statics, capture, shard=0):
            before = read_launches()
            out = run(key, inputs, statics, capture, shard)
            for k, v in read_launches().items():
                shards[shard][k] += v - before[k]
            return out

        b.run = counted
        try:
            reset_launches()
            request(b, name)
            total = read_launches()
        finally:
            del b.run
        if len(graphs_of(b)) != held:
            raise AssertionError(f"phase 16: {name} captured a program")
        return total, shards

    def against(root, want_root, label):
        """Files against another run's: byte-equal, or every difference an
        fp32-boundary cell, each listed."""
        if mid_files(root) != mid_files(want_root):
            raise AssertionError(f"phase 16: {label}: other files")
        equal = 0
        for name in mid_files(want_root):
            with open(os.path.join(root, name), "rb") as fa, \
                    open(os.path.join(want_root, name), "rb") as fb:
                same, faults, borderline = midi_differences(fa.read(),
                                                            fb.read())
            if faults:
                raise AssertionError(f"phase 16: {label}: {name}: {faults}")
            equal += same
            if not same:
                log(f"phase 16: {label}: {name}: fp32-boundary note events "
                    f"{borderline}")
        log(f"phase 16: {label}: {equal} of {len(mid_files(want_root))} "
            f"files byte-equal")
        return equal

    capture(mesh_b, "mesh fp32")
    capture(single, "single fp32")
    launches, shards = by_shard(mesh_b, "mesh_counted")
    want_shard = {"raster": 2, "grid_tail": 1}
    for s, got in enumerate(shards):
        if any(got[k] != want_shard.get(k, 0) for k in names):
            raise AssertionError(f"phase 16: shard {s} launched {got}, want "
                                 f"{want_shard}")
    log(f"phase 16: one replayed mesh request: launches {launches}; by "
        f"shard {shards}")
    against(os.path.join(tmp, "mesh_counted"), want_dir,
            "replayed mesh request against phase 14's replay")

    eager = tr.ModelBundle.from_npz(mesh=mesh, capture=False)
    request(eager, "mesh_eager_warm")
    e_launches, _ = by_shard(eager, "mesh_eager")
    if e_launches != launches or graphs_of(eager):
        raise AssertionError(f"phase 16: the uncaptured mesh request "
                             f"launched {e_launches}")
    if against(os.path.join(tmp, "mesh_eager"),
               os.path.join(tmp, "mesh_counted"),
               "uncaptured mesh request against the replayed one") \
            != len(mid_files(want_dir)):
        raise AssertionError("phase 16: the uncaptured mesh request is not "
                             "bit-equal to the replayed one")

    bf16 = tr.ModelBundle.from_npz(mesh=mesh,
                                   extract_storage_dtype="bfloat16")
    capture(bf16, "mesh bf16 extraction")
    b_launches, b_shards = by_shard(bf16, "mesh_bf16")
    for s, got in enumerate(b_shards):
        if got["raster_bf16"] != 2 or got["raster"] or got["grid_tail"] != 1:
            raise AssertionError(f"phase 16: bf16 extraction shard {s} "
                                 f"launched {got}")
    log(f"phase 16: replayed mesh request, bf16 extraction: launches "
        f"{b_launches}")
    against(os.path.join(tmp, "mesh_bf16"), os.path.join(tmp, "bf16"),
            "bf16-extraction mesh request against phase 5's")
    del bf16, eager

    mesh_s, single_s = [], []
    held = len(graphs_of(mesh_b)), len(graphs_of(single))
    for r in range(6):          # each bundle first in every other turn
        turn = [(mesh_b, mesh_s, "mesh"), (single, single_s, "single")]
        for b, times, label in turn[::-1 if r % 2 else 1]:
            times.append(request(b, f"{label}_timed_{r}"))
    if (len(graphs_of(mesh_b)), len(graphs_of(single))) != held:
        raise AssertionError("phase 16: a timed request captured")

    def spread(v):
        return (f"median {statistics.median(v) * 1e3:.3f} ms (min "
                f"{min(v) * 1e3:.3f}, max {max(v) * 1e3:.3f}; "
                f"{', '.join(f'{t * 1e3:.3f}' for t in v)})")

    log(f"phase 16: 12-job request over the mesh ({layout}), replayed: "
        f"{spread(mesh_s)}; the single-card replay, in turns: "
        f"{spread(single_s)} ({smi})")

    trace = os.path.join(tmp, "trace_mesh")
    traced = {}

    def take():
        with profiler_trace(trace) as end_warmup:
            request(mesh_b, "mesh_trace_warm")
            end_warmup()
            reset_launches()
            wall = request(mesh_b, "mesh_traced")
            traced["launches"] = read_launches()
        return summarize(trace, 1, device="cuda"), wall

    summary, wall = complete_trace("phase 16 traced mesh replay", take)
    got = {k: summary["by_category_launches"].get(k, 0)
           for k in ("K1", "K2", "K3")}
    if got != {"K1": 2 * n, "K2": n, "K3": 0} or \
            traced["launches"] != launches:
        raise AssertionError(f"phase 16: the traced mesh replay's device "
                             f"records {got}, counters {traced['launches']}")
    busy = summary["busy_ms_per_step"]
    host = host_launches(trace)
    log(f"phase 16: traced replayed mesh request: device busy {busy:.3f} ms "
        f"of {wall * 1e3:.3f} ms wall (summed over its cards); K launches "
        f"by kernel name {got}; host launch calls {sum(host.values())} "
        f"{dict(host)} ({smi})")
    log("  device launches by category: " + "; ".join(
        f"{k} {v} ({summary['by_category_ms'].get(k, 0.0):.3f} ms)"
        for k, v in summary["by_category_launches"].items()))

    for p in programs_of(mesh_b):
        keys = [g.key for g in p.graphs.values()]
        if p._capture_stream is None or \
                p._capture_stream.device != p.device:
            raise AssertionError(f"phase 16: programs of {p.device} "
                                 f"captured on another card's stream")
        log(f"phase 16: {p.device}: {len(keys)} graphs held {keys}, "
            f"captured on a stream of {p._capture_stream.device}")

    mesh_b.call_log = calls = []
    request(mesh_b, "mesh_logged")
    mesh_b.call_log = None
    counted_flops = replay_log_flops(mesh_b, calls)
    by_key = {}
    for key, inputs, statics, shard in calls:
        by_key.setdefault(key, []).append(shard)
    log(f"phase 16: call_log of a replayed mesh request: {by_key}; "
        f"replay_log_flops {counted_flops} matmul FLOPs, phase 12's count of "
        f"the single-card request {request_flops}")
    if counted_flops != request_flops:
        pad_songs = -len(comps + styles) % n
        pad_jobs = -len(comps) * (1 + len(styles)) % n
        log(f"phase 16: the counts differ by {counted_flops - request_flops}: "
            f"the mesh runs {sorted(by_key)} where phase 12 ran one "
            f"transfer_fused program, with {pad_songs} pad songs in "
            f"raster_extract and {pad_jobs} pad jobs in fused")
        if not (pad_songs or pad_jobs):
            raise AssertionError("phase 16: the counts differ without pad "
                                 "rows")
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


def _run_cli(args, label):
    """``train-model-torch.py`` in a process of its own; its stdout."""
    proc = subprocess.run([sys.executable, os.path.join(
        ROOT, "train-model-torch.py")] + args, cwd=ROOT, capture_output=True,
        text=True, timeout=RANK_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"phase 15: {label} exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout


def _csv(path):
    import csv
    with open(path) as fh:
        return list(csv.DictReader(fh))


def phase_train_captured(torch, paths, tmp, smi):
    """Phase 15: the training step captured as CUDA graphs and replayed
    (mst_torch.runtime.train on mst_torch.runtime.programs), against the
    same step eager, in turns, from the same seed-108 init on the smoke
    songs. Returns the launches of one replayed fp32 micro-step and one
    bf16 micro-step, by kernel form."""
    import statistics

    from mst_torch.config import Config, ModelConfig, TrainConfig
    from mst_torch.runtime import train as tr
    from mst_torch.runtime.metrics import profiler_trace
    from mst_torch.runtime.profile import summarize
    from mst_torch.transfer import get_model_input

    t_phase = time.perf_counter()
    tr.reproducible_backends()
    songs = [get_model_input(p)[1] for p in paths]
    names = [name for name, _, _ in _counters()]
    # the scheduler on a tensor rate: torch fills it in place (or replaces
    # it, which would leave a graph reading a stale rate)
    probe = tr.create_train_state(Config(), device="cuda", seed=0)
    rate = probe.optimizer.param_groups[0]["lr"]
    with warnings.catch_warnings():
        # stepping the schedule alone: torch warns that no step ran
        warnings.simplefilter("ignore")
        probe.scheduler.step()
    kept = probe.optimizer.param_groups[0]["lr"] is rate
    log(f"phase 15: torch {torch.__version__}: LambdaLR.step() "
        f"{'fills the tensor rate in place' if kept else 'REPLACES the tensor rate'}"
        f"; Adam capturable {probe.optimizer.param_groups[0]['capturable']}"
        f", step count on {probe.optimizer.state[next(probe.model.parameters())]['step'].device}")
    if not kept:
        raise AssertionError("phase 15: the scheduler replaced the tensor "
                             "rate")
    del probe

    def batch_of(group, config):
        """The batch of ``group`` (songs that share beats-per-bar), bucketed
        and capped as train-model-torch.py does."""
        return group_batch(tr, group, config.train, "cuda",
                           config.model.storage_dtype)

    def same(a, b):
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    def param_gap(a, b):
        """(bit-equal, largest |difference| relative to the leaf's largest
        |value|) over parameters, gradient buffers and Adam moments."""
        equal, gap = True, 0.0
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            sa, sb = a.optimizer.state[p], b.optimizer.state[q]
            for x, y in ((p, q), (p.grad, q.grad),
                         (sa["exp_avg"], sb["exp_avg"]),
                         (sa["exp_avg_sq"], sb["exp_avg_sq"])):
                if not same(x.detach(), y.detach()):
                    equal = False
                    gap = max(gap, _rel_err(x.detach(), y.detach()))
        return equal, gap

    def run_pair(label, config, plan, k=1, want=None, trace=None):
        """Each (songs) call of ``plan`` on a captured state and on an eager
        one, in turns; losses after every call and the whole state after
        every apply against each other. ``want``: the launches of every
        captured call (counters at 0 first). Returns a summary."""
        states = {m: tr.create_train_state(config, device="cuda", seed=108)
                  for m in ("captured", "eager")}
        make = tr.make_train_step if k == 1 else (
            lambda c, u, capture: tr.make_multi_train_step(
                c, u, k, capture=capture))
        fns = {}
        times = {"replay": [], "capture": [], "eager": []}
        full = {"replay": [], "eager": []}
        peaks = {"captured": 0, "eager": 0}
        worst, equal_all = 0.0, True
        for i, group in enumerate(plan):
            vecs = {}
            for mode in ("captured", "eager"):
                state = states[mode]
                t_full = time.perf_counter()
                batch = batch_of(group, config)
                has_u = batch.unpitched is not None
                if (mode, has_u) not in fns:
                    fns[mode, has_u] = make(config, has_u,
                                            capture=mode == "captured")
                graphs = (0 if state.programs is None
                          else len(state.programs.graphs))
                applies = state.opt_step
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                _, vec = fns[mode, has_u](state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                peaks[mode] = max(peaks[mode],
                                  torch.cuda.max_memory_allocated())
                vecs[mode] = vec
                vec.cpu()
                dt_full = time.perf_counter() - t_full
                got = read_launches()
                if mode == "eager":
                    times["eager"].append(dt)
                    full["eager"].append(dt_full)
                    continue
                captured = len(state.programs.graphs) > graphs
                times["capture" if captured else "replay"].append(dt)
                if not captured:
                    full["replay"].append(dt_full)
                if want is not None and got != {n: want.get(n, 0)
                                                 for n in names}:
                    raise AssertionError(f"phase 15: {label} call {i} "
                                         f"launched {got}, want {want}")
                applied = state.opt_step > applies
            if not same(vecs["captured"], vecs["eager"]):
                equal_all = False
                worst = max(worst, _rel_err(vecs["captured"].cpu(),
                                            vecs["eager"].cpu()))
            if applied:
                equal, gap = param_gap(states["captured"], states["eager"])
                equal_all &= equal
                worst = max(worst, gap)
        reserved = torch.cuda.memory_reserved() / 2 ** 30
        cap = states["captured"]
        graphs = list(cap.programs.graphs.items())
        if (cap.micro_step, cap.opt_step) != (states["eager"].micro_step,
                                              states["eager"].opt_step):
            raise AssertionError(f"phase 15: {label}: counters differ")
        log(f"phase 15: {label}: {len(plan)} calls, captured against eager "
            f"in turns: losses after every call and the state after every "
            f"apply {'bit-equal' if equal_all else f'differ by {worst:.3g} relative (bound {CAPTURE_RTOL})'}"
            f"; {len(graphs)} graphs held; peak device memory allocated "
            f"in a call: captured {peaks['captured'] / 2 ** 30:.3f} GiB "
            f"(a replay allocates nothing: its work lies in the graphs' "
            f"pool), eager {peaks['eager'] / 2 ** 30:.3f} GiB; "
            f"{reserved:.3f} GiB reserved in all ({smi})")
        if not worst <= CAPTURE_RTOL:
            raise AssertionError(f"phase 15: {label}: captured and eager "
                                 f"differ by {worst} > {CAPTURE_RTOL}")
        for ckey, g in graphs:
            shapes = [sig[0] for sig in ckey[2] if sig is not None][:3]
            log(f"  graph {g.key} {dict(ckey[3])} inputs {shapes}: "
                f"capture cost: first (real) step {g.warmup_s * 1e3:.3f} ms "
                f"+ capture {g.capture_s * 1e3:.3f} ms; a replay launches "
                f"{dict((n, c) for n, c in zip(names, g.launches) if c)}")

        def spread(v):
            if not v:
                return "none"
            return (f"median {statistics.median(v) * 1e3:.3f} ms (min "
                    f"{min(v) * 1e3:.3f}, max {max(v) * 1e3:.3f}, n "
                    f"{len(v)})")

        log(f"  ms per call: replayed {spread(times['replay'])}; eager "
            f"{spread(times['eager'])}; first calls (real step + capture) "
            f"{spread(times['capture'])}")
        log(f"  with the batch build and the loss fetch: replayed "
            f"{spread(full['replay'])}; eager {spread(full['eager'])} "
            f"({smi})")
        return dict(states=states, fns=fns)

    def policy(bf16):
        return (dict(storage_dtype="bfloat16", compute_dtype="bfloat16")
                if bf16 else {})

    # 10 batch-1 micro-steps, iter_size 2, the rate decaying every 2 applies
    plan = [[songs[i % len(songs)]] for i in range(10)]
    launches = {}
    results = {}
    for bf16 in (False, True):
        config = Config(model=ModelConfig(**policy(bf16)),
                        train=TrainConfig(lr_decay_every=2))
        sfx = "_bf16" if bf16 else ""
        want = {"grid_tail" + sfx: 1, "grid_tail_bwd" + sfx: 1}
        label = f"10 batch-1 {'bf16' if bf16 else 'fp32'} micro-steps"
        results[bf16] = run_pair(label, config, plan, want=want)
        launches.update({n: launches.get(n, 0) + want.get(n, 0)
                         for n in names})
        if results[bf16]["states"]["captured"].opt_step != 5:
            raise AssertionError("phase 15: 5 applies expected")

    # a traced replayed pair (fp32): the plan goes on with songs 4, 5, 0,
    # each call on a key steps 4, 5 and 0 captured; the first warms the
    # tracer up
    run = results[False]
    state = run["states"]["captured"]
    config = Config(train=TrainConfig(lr_decay_every=2))
    trace = os.path.join(tmp, "trace_captured_pair")
    cursor = [10]

    def call():
        song = songs[cursor[0] % len(songs)]
        batch = batch_of([song], config)
        fn = run["fns"]["captured", batch.unpitched is not None]
        held = len(state.programs.graphs)
        fn(state, batch)
        cursor[0] += 1
        if len(state.programs.graphs) != held:
            raise AssertionError("phase 15: a traced call captured")

    def take():
        with profiler_trace(trace) as end_warmup:
            call()
            torch.cuda.synchronize()
            end_warmup()
            t0 = time.perf_counter()
            call()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return summarize(trace, 2, device="cuda"), wall

    summary, wall = complete_trace("phase 15 traced replayed pair", take)
    busy = summary["busy_ms_per_step"] * 2
    host = host_launches(trace)
    eager_host = host_launches(os.path.join(tmp, "trace_pair"))
    got = {k: summary["by_category_launches"].get(k, 0)
           for k in ("K1", "K2", "K3")}
    log(f"phase 15: traced replayed pair of fp32 micro-steps: device busy "
        f"{busy:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({busy / (wall * 1e3):.1%}); launches a step by kernel name {got} "
        f"(K1 builds the batch); host launch calls {sum(host.values())} "
        f"{dict(host)}; phase 7's eager pair: {sum(eager_host.values())} "
        f"({smi})")
    if got != {"K1": 2, "K2": 1, "K3": 1}:
        raise AssertionError(f"phase 15: the traced pair's device records "
                             f"{got} a step, want K1 2, K2 1 and K3 1")
    del results, run, state
    torch.cuda.empty_cache()

    # one bf16 remat micro-step pattern: 3 calls on one song (the third
    # replays the first's graph); K2's bf16 form launches twice a call
    config = Config(model=ModelConfig(**policy(True)),
                    train=TrainConfig(remat=True))
    run_pair("bf16 remat micro-steps", config, [[songs[0]]] * 3,
             want={"grid_tail_bf16": 2, "grid_tail_bwd_bf16": 1})

    # a k=2 stack of two songs of one beats-per-bar, 3 calls (the second
    # and third replay), iter_size 2: each call applies once
    pair = [s for s in songs if s.beats_per_bar == songs[0].beats_per_bar]
    config = Config()
    run_pair("k=2 stacks (fp32)", config, [pair[:2]] * 3, k=2,
             want={"grid_tail": 2, "grid_tail_bwd": 2})
    torch.cuda.empty_cache()

    # the CLI: captured and --no-capture give the same rows; a captured
    # --resume gives the uninterrupted run's rows again
    data = os.path.join(ROOT, "mst_torch", "assets", "smoke")
    base = ["--data", data, "--save-interval", "4", "--seed", "108"]
    t_cli = time.perf_counter()
    out = {}
    for name, extra in (("captured", []), ("eager", ["--no-capture"])):
        t0 = time.perf_counter()
        stdout = _run_cli(base + ["--iters", "12", "--csv",
                                  os.path.join(tmp, f"cli_{name}.csv"),
                                  "--snapshots",
                                  os.path.join(tmp, f"cli_{name}")] + extra,
                          f"train-model-torch.py ({name})")
        want_line = ("Steps: captured as CUDA graphs" if name == "captured"
                     else "Steps: eager")
        if want_line not in stdout:
            raise AssertionError(f"phase 15: the {name} CLI did not say "
                                 f"{want_line!r}")
        out[name] = time.perf_counter() - t0
    cap_rows = _csv(os.path.join(tmp, "cli_captured.csv"))
    eager_rows = _csv(os.path.join(tmp, "cli_eager.csv"))
    if cap_rows != eager_rows or len(cap_rows) != 12:
        raise AssertionError("phase 15: the CLI's captured and --no-capture "
                             "rows differ")
    _run_cli(base + ["--iters", "16", "--resume", "--csv",
                     os.path.join(tmp, "cli_captured.csv"), "--snapshots",
                     os.path.join(tmp, "cli_captured")],
             "train-model-torch.py --resume (captured)")
    rows = _csv(os.path.join(tmp, "cli_captured.csv"))
    again = [r for r in rows[12:] if int(r["iteration"]) < 12]
    if not again or again != cap_rows[-len(again):] or \
            [r["iteration"] for r in rows[12:]] != [
                str(i) for i in range(16 - len(rows[12:]), 16)]:
        raise AssertionError(f"phase 15: the captured resume's rows differ "
                             f"from the uninterrupted run's")
    log(f"phase 15: train-model-torch.py --iters 12, captured "
        f"({out['captured']:.1f} s) and --no-capture ({out['eager']:.1f} "
        f"s): 12 CSV rows equal; a captured --resume to 16 repeats "
        f"iterations {[r['iteration'] for r in again]} with the "
        f"uninterrupted run's rows ({time.perf_counter() - t_cli:.1f} s "
        f"for the three runs)")
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s ({smi})")
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

    smi = phase_setup(torch)
    comps, styles = smoke_paths()
    t0 = time.perf_counter()
    songs = [get_model_input(p)[1] for p in comps + styles]
    log(f"host ingest of {len(songs)} songs: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    # phases 2-13 run the programs uncaptured (capture=False), as before
    # phase 14; phase 14 captures them
    bundle = ModelBundle.from_npz(device="cuda", capture=False)
    kernels = phase_k1(torch, bundle, songs) + phase_k2(torch)
    with tempfile.TemporaryDirectory() as tmp:
        serve, serve_bf16, serve_flops = phase_main(torch, bundle, comps,
                                                    styles, tmp)
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
        torch.cuda.empty_cache()
        parallel = phase_parallel(torch, comps[:1] + styles[:1], tmp, smi)
        torch.cuda.empty_cache()
        seq = phase_seq(torch, comps[:1] + styles[:1], tmp, smi)
        phase_flops(serve_flops, fp32, bf16, smi)
        phase_profile(torch, serve_flops, fp32, bf16, comps, styles, tmp,
                      smi)
        torch.cuda.empty_cache()
        captured = phase_captured(torch, comps, styles, tmp, smi,
                                  serve_flops["request"])
        torch.cuda.empty_cache()
        mesh = phase_mesh(torch, comps, styles, songs, tmp, smi,
                          serve_flops["request"])
        torch.cuda.empty_cache()
        train_captured = phase_train_captured(torch, comps + styles, tmp,
                                              smi)
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
                   "bf16 remat micro-step": remat[name],
                   "2-rank data-parallel micro-steps, rank 0":
                       parallel[name],
                   "2-seq-rank bar-sharded micro-steps, rank 0": seq[name],
                   "captured transfer request (one replay)":
                       captured[name],
                   "captured mesh request (one replay a shard)":
                       mesh[name],
                   "captured micro-steps (one fp32 and one bf16 replay)":
                       train_captured[name]}
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
