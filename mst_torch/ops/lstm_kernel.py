"""K4: the LSTM recurrence as one hand-written CUDA kernel a recurrence.

Replaces no TPU kernel: the JAX package scans the recurrence with
``lax.scan`` (mst_tpu/ops/lstm.py), one loop on the device. Its plain
version here, ``recur_plain``, is a Python loop of one ``bmm`` and about
ten elementwise kernels a step, so a recurrence over 128 bars costs about
1,400 launches. K4 (``csrc/lstm_recur.cu``) runs every step in one launch;
the source's header says what bounds it on the H100 (the latency of a step
on the bar axis, operations or bytes on the beat axis) and what its design
does about it: persistent blocks that keep W_hh in shared memory and the
carries on chip, a thread-block cluster that splits the hidden units where
W_hh does not fit one block, the new h sent to every block of the cluster
through distributed shared memory.

``lstm_recur`` is the wrapper: (K, N, T, 4H) fp32 gates_x and (K, H, 4H)
fp32 w_hh_t -> the (K, N, T, H) fp32 outputs of K independent recurrences
from zero carries. CPU tensors take ``recur_plain``; CUDA tensors launch
K4 on the current stream, without waiting for the device, or raise.
Nothing records a gradient through it: mst_torch.ops.lstm calls it where
none is needed (serving runs under ``torch.inference_mode``).

``lstm_recur_train`` is the same recurrence with its gradient, the
autograd function ``LstmRecur``, which mst_torch.ops.lstm takes on the
card where autograd records (training's step). Its forward runs K4's
training form, which also saves every step's gate activations and c; its
backward runs K4's backward kernel over them (``lstm_recur_bwd``), which
gives the gate cotangents dgates, the gradient of gates_x, and then
w_hh_t's gradient, sum_t h[t-1]^T dgates[t], as one batched product
(``weight_grad``). The input projection's and the biases' gradients flow
from dgates through ordinary autograd. The plain versions beside them,
``recur_saved_plain`` and ``recur_bwd_plain`` (the backward over saved
gates as a loop of tensor ops), run for CPU tensors.

The compute dtype (mst_torch.ops.precision) is read on the caller's
thread when the kernel launches and picks the form: under fp32 the
products are full fp32 (no TF32); under bf16, W_hh and each step's h are
rounded to bf16 and the products accumulate in fp32, as
``precision.matmul`` does. The carries and outputs are fp32 in both.
``lstm_recur.launches`` counts the fp32 form's launches,
``lstm_recur.launches_bf16`` the bf16 form's, training forms included;
``lstm_recur_bwd.launches`` and ``.launches_bf16`` the backward's. A
forward launch adds the 2 K N T H 4H matmul FLOPs of the loop's products
to the counts open on its thread (mst_torch.runtime.flops), which cannot
see a kernel; a backward launch adds those of the loop's products for the
carried dh, 2 K N (T - 1) H 4H (the first step's h is a constant), and
the weight gradient's product counts itself, so a step counts what the
loop's does. ``LstmRecur`` keeps in ``ctx`` what its backward needs (the
compute dtype and the backward's launch plan; the card is its saved
tensors'), since the backward runs on the autograd engine's thread, which
sees no precision policy.

Widths: every H up to ``MAX_FEATURES`` (256); a wider one raises. ``plan``
gives the launch shape from H, N, K, the compute dtype and the card's SM
count, for the forward or the backward: the cluster size that fits W_hh's
share of a block in ``W_BUDGET`` bytes of shared memory, then the row
tile, then the lanes each dot product is split over.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from mst_torch.ops import cuda_build, precision
from mst_torch.ops.flop_scope import add_bmm_flops
from mst_torch.ops.precision import BF16, FP32

MAX_FEATURES = 256        # H
MAX_THREADS = 256         # threads of a block: split x units x row groups
MAX_ROWS_PER_THREAD = 8   # R, a template parameter of the kernel: 1-8
MAX_SPLIT = 8             # lanes that share one dot product
MAX_TILE = 64             # rows of a block
W_BUDGET = 160 * 1024     # bytes of W_hh a block holds in shared memory
SMEM_LIMIT = 232448       # the H100's opt-in shared memory per block


def _cell(gates, c):
    """The cell of one step from its gates (K, N, 4H): the new (h, c) and
    the activations (i, f, g, o) after their functions."""
    i, f, g, o = gates.chunk(4, dim=-1)
    acts = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
            torch.sigmoid(o))
    si, sf, tg, so = acts
    c = sf * c + si * tg
    h = so * torch.tanh(c)
    return h, c, acts


def lstm_step(gates_x, h, c, w_hh_t):
    """One step of the recurrence: ``gates_x`` (K, N, 4H) of this step,
    carries ``h``, ``c`` (K, N, H), ``w_hh_t`` (K, H, 4H) already cast by
    ``precision.cast_operand``. Returns the new (h, c)."""
    h, c, _ = _cell(gates_x + precision.matmul(h, w_hh_t), c)
    return h, c


def recur_plain(gates_x, w_hh_t):
    """The plain version: the recurrence as a loop of ``lstm_step``.
    ``gates_x``: (K, N, T, 4H) for K independent directions, ``w_hh_t``:
    (K, H, 4H). Returns outputs (K, N, T, H). Records gradients."""
    k, n, t, _ = gates_x.shape
    h_dim = w_hh_t.shape[1]
    # the carries follow the gates' dtype: fp32 under either policy
    h = gates_x.new_zeros(k, n, h_dim)
    c = gates_x.new_zeros(k, n, h_dim)
    w_hh_t = precision.cast_operand(w_hh_t)
    outs = []
    for step in range(t):
        h, c = lstm_step(gates_x[:, :, step], h, c, w_hh_t)
        outs.append(h)
    return torch.stack(outs, dim=2)


def recur_saved_plain(gates_x, w_hh_t, bf16: bool):
    """The plain version of K4's training form: ``recur_plain``'s outputs,
    bit for bit, under the compute dtype ``bf16`` names, with what the
    backward reads: (outputs (K, N, T, H), activations (K, N, T, 4H), i,
    f, g, o after their functions, c (K, N, T, H)). Records no
    gradient."""
    k, n, t, _ = gates_x.shape
    h_dim = w_hh_t.shape[1]
    with torch.no_grad(), precision.precision(BF16 if bf16 else FP32):
        h = gates_x.new_zeros(k, n, h_dim)
        c = gates_x.new_zeros(k, n, h_dim)
        w = precision.cast_operand(w_hh_t)
        outs, acts, cs = [], [], []
        for step in range(t):
            h, c, a = _cell(gates_x[:, :, step] + precision.matmul(h, w), c)
            outs.append(h)
            acts.append(torch.cat(a, dim=-1))
            cs.append(c)
        return (torch.stack(outs, dim=2), torch.stack(acts, dim=2),
                torch.stack(cs, dim=2))


def _bf16_values(x):
    """``x`` rounded to bf16, held in its own dtype."""
    return x.to(BF16).to(x.dtype)


def recur_bwd_plain(dout, acts, cs, w_hh_t, bf16: bool):
    """The plain version of K4's backward: the gate cotangents dgates (K,
    N, T, 4H) from the outputs' cotangent ``dout`` (K, N, T, H), the saved
    activations and c (``recur_saved_plain``'s) and ``w_hh_t`` (K, H, 4H),
    walking the steps in reverse with the factors in the kernel's order
    (csrc/lstm_recur.cu's header). Under ``bf16`` W_hh is rounded to bf16
    and each step's carried dh (an fp32 product) too, as precision.matmul's
    backward rounds the cotangent of its bf16 operand h. Reads no
    policy."""
    k, n, t, h_dim = dout.shape
    w = _bf16_values(w_hh_t) if bf16 else w_hh_t
    w_t = w.transpose(1, 2)
    dgates = torch.empty_like(acts)
    carry = torch.zeros_like(dout[:, :, 0])
    dc = torch.zeros_like(carry)
    for step in reversed(range(t)):
        si, sf, tg, so = acts[:, :, step].chunk(4, dim=-1)
        c_prev = cs[:, :, step - 1] if step else torch.zeros_like(dc)
        dh = dout[:, :, step] + carry
        tc = torch.tanh(cs[:, :, step])
        d_o = dh * tc * (1 - so) * so
        dcr = dc + dh * so * (1 - tc * tc)
        d_i = dcr * tg * (1 - si) * si
        d_f = dcr * c_prev * (1 - sf) * sf
        d_g = dcr * si * (1 - tg * tg)
        dc = dcr * sf
        dgates[:, :, step] = torch.cat([d_i, d_f, d_g, d_o], dim=-1)
        if step:
            carry = torch.matmul(dgates[:, :, step], w_t)
            if bf16:
                carry = _bf16_values(carry)
    return dgates


def weight_grad(out, dgates, bf16: bool):
    """w_hh_t's gradient, sum_t h[t-1]^T dgates[t] (h[-1] = 0), as one
    batched product over every row and step: (K, H, 4H) from the outputs
    (K, N, T, H) and dgates (K, N, T, 4H). Under ``bf16`` the h operands
    are rounded to bf16, the products summed in fp32 and the sum rounded
    to bf16, as precision.matmul's backward gives the cotangent of its
    bf16 operand W_hh. The product spans every step, the first's zero h
    too, so it counts the FLOPs of the loop's T weight products."""
    k, n, t, h_dim = out.shape
    h_prev = F.pad(out[:, :, :-1], (0, 0, 1, 0)).reshape(k, n * t, h_dim)
    if bf16:
        h_prev = _bf16_values(h_prev)
    dw = torch.bmm(h_prev.transpose(1, 2), dgates.reshape(k, n * t, -1))
    return _bf16_values(dw) if bf16 else dw


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """K4's launch shape. A cluster of ``cluster`` blocks takes ``rows``
    rows of one direction; each block holds ``units`` hidden units and
    runs ``split`` x ``units`` x ``groups`` threads: ``split`` lanes share
    a unit's dot products, each lane owns ``rows_per_thread`` rows;
    ``smem_bytes`` of shared memory a block."""
    cluster: int
    units: int
    split: int
    rows_per_thread: int
    groups: int
    smem_bytes: int

    @property
    def rows(self) -> int:
        return self.rows_per_thread * self.groups

    @property
    def threads(self) -> int:
        return self.split * self.units * self.groups

    def blocks(self, k: int, n: int) -> int:
        return k * _cdiv(n, self.rows) * self.cluster


def _smem_bytes(h: int, units: int, rows: int, bf16: bool,
                split: int = 1, bwd: bool = False) -> int:
    """csrc/lstm_recur.cu's smem_bytes: W_hh's share at 8 (bf16) or 16
    bytes a (padded depth, unit), and two buffers of h (the backward's:
    of the four gate cotangents a unit), each split's segment of a row
    padded by 4 floats."""
    ks = _cdiv(_cdiv(h, split), 4) * 4
    width = 4 if bwd else 1
    return (split * ks * units * (8 if bf16 else 16)
            + 2 * rows * split * (width * ks + 4) * 4)


def _check_width(h: int) -> None:
    if not 1 <= h <= MAX_FEATURES:
        raise ValueError(f"lstm_recur: H = {h}; K4 takes 1 to "
                         f"{MAX_FEATURES} hidden units")


def plan(k: int, n: int, h: int, bf16: bool, sms: int,
         bwd: bool = False) -> Plan:
    """K4's launch shape for K directions over N rows with H units on a
    card of ``sms`` SMs, in the bf16 form or not, for the forward or (with
    ``bwd``) the backward, whose exchange buffers are four times wider.

    The cluster: the fewest blocks (1, 2, 4, 8) whose share of W_hh fits
    ``W_BUDGET``. The row tile: 1 row a cluster while the clusters fit the
    SMs (the bar axis: the step's latency is the bound, so the work
    spreads), doubled up to ``MAX_TILE`` rows while they do not (the beat
    axis). Within a block, one thread a (unit, row) up to ``MAX_THREADS``
    threads, then up to 8 rows a thread; a tile that still needs more
    threads, or more shared memory than a block has, is cut. The split:
    the threads left over shorten each dot product's chain, at least 4
    depths a lane."""
    _check_width(h)
    cluster = 1
    while _smem_bytes(h, _cdiv(h, cluster), 0, bf16) > W_BUDGET:
        cluster *= 2
    units = _cdiv(h, cluster)
    tile = 1
    while k * _cdiv(n, tile) * cluster > sms and tile < MAX_TILE:
        tile *= 2
    while True:
        rows_per_thread = 1
        while (rows_per_thread < MAX_ROWS_PER_THREAD
               and units * _cdiv(tile, rows_per_thread) > MAX_THREADS):
            rows_per_thread *= 2
        groups = min(_cdiv(tile, rows_per_thread), MAX_THREADS // units)
        split = 1
        while (split < MAX_SPLIT and h >= 8 * split
               and 2 * split * units * groups <= MAX_THREADS):
            split *= 2
        smem = _smem_bytes(h, units, rows_per_thread * groups, bf16, split,
                           bwd)
        if smem <= SMEM_LIMIT or tile == 1:
            return Plan(cluster, units, split, rows_per_thread, groups, smem)
        tile //= 2


@functools.cache
def _entry():
    """The forward's C entry point of csrc/lstm_recur.cu (built and bound
    once)."""
    fn = cuda_build.load("lstm_recur").mst_lstm_recur
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    """The backward's C entry point of csrc/lstm_recur.cu."""
    fn = cuda_build.load("lstm_recur").mst_lstm_recur_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(gates_x, w_hh_t):
    """(K, N, T, H) after checking the shapes and dtypes."""
    if gates_x.dim() != 4 or w_hh_t.dim() != 3:
        raise ValueError(f"lstm_recur: gates_x {tuple(gates_x.shape)} must "
                         f"be (K, N, T, 4H) and w_hh_t "
                         f"{tuple(w_hh_t.shape)} (K, H, 4H)")
    k, n, t, four_h = gates_x.shape
    h = w_hh_t.shape[1]
    if tuple(w_hh_t.shape) != (k, h, 4 * h) or four_h != 4 * h:
        raise ValueError(f"lstm_recur: gates_x {tuple(gates_x.shape)} and "
                         f"w_hh_t {tuple(w_hh_t.shape)} must be (K, N, T, "
                         f"4H) and (K, H, 4H)")
    _check_width(h)
    for name, x in (("gates_x", gates_x), ("w_hh_t", w_hh_t)):
        if x.dtype != FP32:
            raise ValueError(f"lstm_recur: {name} is {x.dtype}; the kernel "
                             f"takes float32")
    if w_hh_t.device != gates_x.device:
        raise ValueError(f"lstm_recur: w_hh_t on {w_hh_t.device}, gates_x "
                         f"on {gates_x.device}")
    return k, n, t, h


def _launch(gates_x, w_hh_t, bf16: bool, train: bool):
    """One launch of K4's forward on the current stream: the outputs, and
    in the training form the activations and c (else None)."""
    k, n, t, _ = gates_x.shape
    h = w_hh_t.shape[1]
    dev = gates_x.device
    gates_x = gates_x.contiguous()
    out = torch.empty(k, n, t, h, dtype=FP32, device=dev)
    acts = cs = None
    if train:
        acts = torch.empty(k, n, t, 4 * h, dtype=FP32, device=dev)
        cs = torch.empty(k, n, t, h, dtype=FP32, device=dev)
    if out.numel() == 0:
        return out, acts, cs
    p = plan(k, n, h, bf16, _sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):            # the thread's current card
        rc = _entry()(gates_x.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(),
                      acts.data_ptr() if train else None,
                      cs.data_ptr() if train else None,
                      k, n, t, h, *w_hh_t.stride(), p.cluster, p.units,
                      p.split, p.rows_per_thread, p.groups, int(bf16),
                      int(train), stream)
    if rc != 0:
        raise RuntimeError(f"LSTM recurrence kernel launch failed: CUDA "
                           f"error {rc} (plan {p})")
    if bf16:
        lstm_recur.launches_bf16 += 1
    else:
        lstm_recur.launches += 1
    add_bmm_flops(2 * k * n * t * h * 4 * h)
    return out, acts, cs


def lstm_recur(gates_x, w_hh_t):
    """The K4 wrapper: K recurrences from zero carries, (K, N, T, 4H) and
    (K, H, 4H) fp32 -> (K, N, T, H) fp32, in the form of the compute dtype
    in force. CPU tensors run ``recur_plain``; CUDA tensors run K4 on the
    current stream, without waiting for the device. ``gates_x`` is read
    contiguous (a view is copied first); ``w_hh_t`` may be any strided
    view (a transposed weight). Records no gradient."""
    _check(gates_x, w_hh_t)
    if gates_x.device.type == "cpu":
        return recur_plain(gates_x, w_hh_t)
    if not gates_x.is_cuda:
        raise ValueError(f"lstm_recur: unsupported device {gates_x.device}")
    return _launch(gates_x, w_hh_t, precision.compute_dtype() == BF16,
                   train=False)[0]


lstm_recur.launches = 0
lstm_recur.launches_bf16 = 0


def bwd_flops(k: int, n: int, t: int, h: int) -> int:
    """The matmul FLOPs of the loop's products for the carried dh over T
    steps, which K4's backward does: the first step's h is a constant, so
    T - 1 of them."""
    return 2 * k * n * (t - 1) * h * 4 * h


def lstm_recur_bwd(dout, acts, cs, w_hh_t, p: Plan, bf16: bool):
    """K4's backward on the current stream: dgates (K, N, T, 4H) fp32
    from the outputs' cotangent ``dout`` (K, N, T, H), the training form's
    ``acts`` and ``cs``, and ``w_hh_t`` (any strided view), with the
    launch plan ``p`` (``plan(..., bwd=True)``) and form ``bf16`` given by
    the caller. Without waiting for the device; raises if the launch
    fails."""
    k, n, t, h = dout.shape
    dout = dout.contiguous()
    if dout.dtype != FP32:
        raise ValueError(f"lstm_recur_bwd: dout is {dout.dtype}; the kernel "
                         f"takes float32")
    dgates = torch.empty_like(acts)
    if dgates.numel() == 0:
        return dgates
    dev = dout.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _bwd_entry()(dout.data_ptr(), acts.data_ptr(), cs.data_ptr(),
                          w_hh_t.data_ptr(), dgates.data_ptr(), k, n, t, h,
                          *w_hh_t.stride(), p.cluster, p.units, p.split,
                          p.rows_per_thread, p.groups, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"LSTM recurrence backward kernel launch failed: "
                           f"CUDA error {rc} (plan {p})")
    if bf16:
        lstm_recur_bwd.launches_bf16 += 1
    else:
        lstm_recur_bwd.launches += 1
    add_bmm_flops(bwd_flops(k, n, t, h))
    return dgates


lstm_recur_bwd.launches = 0
lstm_recur_bwd.launches_bf16 = 0


class LstmRecur(torch.autograd.Function):
    """The recurrence with its gradient: K4's training form forward and
    K4's backward on the card, ``recur_saved_plain`` and
    ``recur_bwd_plain`` for CPU tensors. ``bf16``: the compute form, read
    by the caller. Saves the outputs, the activations, c and w_hh_t; the
    backward reads only ``ctx``."""

    @staticmethod
    def forward(ctx, gates_x, w_hh_t, bf16):
        ctx.bf16 = bf16
        ctx.plan = None
        if gates_x.is_cuda:
            k, n, _, four_h = gates_x.shape
            out, acts, cs = _launch(gates_x, w_hh_t, bf16, train=True)
            ctx.plan = plan(k, n, four_h // 4, bf16,
                            _sm_count(gates_x.device.index), bwd=True)
        else:
            out, acts, cs = recur_saved_plain(gates_x, w_hh_t, bf16)
        ctx.save_for_backward(out, acts, cs, w_hh_t)
        return out

    @staticmethod
    def backward(ctx, dout):
        out, acts, cs, w_hh_t = ctx.saved_tensors
        if dout.is_cuda:
            dgates = lstm_recur_bwd(dout, acts, cs, w_hh_t, ctx.plan,
                                    ctx.bf16)
        else:
            dgates = recur_bwd_plain(dout, acts, cs, w_hh_t, ctx.bf16)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = weight_grad(out, dgates, ctx.bf16)
        return dgates, dw, None


def lstm_recur_train(gates_x, w_hh_t):
    """The recurrence with its gradient (``LstmRecur``) in the form of the
    compute dtype in force: (K, N, T, 4H) and (K, H, 4H) float32 ->
    (K, N, T, H) float32, on the card or (the plain versions) the CPU."""
    _check(gates_x, w_hh_t)
    if not (gates_x.is_cuda or gates_x.device.type == "cpu"):
        raise ValueError(f"lstm_recur: unsupported device {gates_x.device}")
    return LstmRecur.apply(gates_x, w_hh_t,
                           precision.compute_dtype() == BF16)
