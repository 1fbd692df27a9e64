"""K2 and K3: the pitched applier's note-grid tail, forward and backward, as
hand-written CUDA kernels.

K2 replaces the Pallas TPU kernel ``mst_tpu/ops/pallas_grid.py:_fwd_kernel``
(via ``_tail_t_fwd``, :217-231, and ``fused_grid_tail``, :434) and holds the
numerics of the serving path's ``_tail_unrolled`` (:284-310):

    out = sigmoid(sum_k LR(LR(xo)[o,k] + LR(xd)[d,k]) * w[k,f] + rest) * scale

K3 replaces ``_bwd_kernel`` (via ``_tail_t_bwd``, :234-258): from the saved
output and the output's cotangent it recomputes the grid and forms the
cotangents of xo, xd, w and rest.

The kernel sources are ``csrc/grid_tail.cu`` and ``csrc/grid_tail_bwd.cu``;
their headers say what bounds each on the H100 and what the design does
about it: the (…, 8, 7, 30) grid is never stored; both are persistent
kernels that stream 8-row tiles through a ring in shared memory with TMA
bulk copies (``csrc/tile_ring.cuh``). K2 reads ``rest`` per song, never
expanded over channels, finds each tile's rest rows once and reads ``w``
from constant memory. K3 forms each (row, o, d, k) of the grid once, in
one pass that a warp per row makes, and sums ct_w per block in a fixed
order. Both wrappers pass the five scales by value and never wait for the
device.

``grid_tail`` is the entry point. With autograd recording it runs
``GridTail``, whose forward is K2 and whose backward is K3; otherwise (under
``torch.inference_mode``, the serving path) it runs K2 alone and saves
nothing. ``grid_tail_fwd`` and ``grid_tail_bwd`` are the kernel wrappers:
CPU tensors take the plain versions ``grid_tail_plain`` and
``grid_tail_bwd_plain``; tensors anywhere else launch the kernel or raise.
``grid_tail.launches`` and ``grid_tail_bwd.launches`` count kernel
launches. The tail counts no matmul FLOPs on any route
(mst_torch.runtime.flops): the plain versions run inside ``uncounted``.
Both kernels are built without FMA contraction, so on the card they agree
with their plain versions bit for bit, apart from ct_w, a sum over every
row taken in another order (``chip_smoke.py`` states each tolerance).

Each kernel has two forms, chosen by the dtype of ``xo`` and ``xd``:

- fp32: every input and output fp32 (the fp32 storage policy);
- bf16 (the bf16 storage policy, mst_torch.ops.precision): ``xo``, ``xd``,
  the output, its cotangent ``ct`` and ``ct_xo``/``ct_xd`` are bf16; ``w``,
  ``rest``, ``ct_y`` (d rest) and ``ct_w`` stay fp32. JAX runs its jnp tail
  under that policy (pallas_grid.py:454-467); the bf16 form rounds where
  the jaxpr of ``_tail_jnp`` and of its gradient on bf16 inputs rounds
  (``grid_tail_plain`` and ``grid_tail_bwd_plain`` list the points). Its
  forward also writes the output as bf16, the ``cast_storage`` of
  appliers.py:89 fused.

Any other dtype raises: nothing is converted behind the caller's back.
``launches`` counts the fp32 form's launches, ``launches_bf16`` the bf16
form's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from mst_torch.ops import cuda_build
from mst_torch.ops.flop_scope import uncounted
from mst_torch.ops.precision import BF16, FP32, bf16_value

N_OCTAVES = 8
N_SCALE_DEGREES = 7
GRID_DEPTH = 30
N_FEATURES = 5
_SLOPE = 0.01
_SLOPE_BF16 = bf16_value(_SLOPE)    # 0.010009765625


_SCALES = [ctypes.c_float] * 5


@functools.cache
def _entry():
    """The C entry point of csrc/grid_tail.cu (built and bound once)."""
    fn = cuda_build.load("grid_tail").mst_grid_tail
    fn.argtypes = [ctypes.c_void_p] * 4 + _SCALES + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    """(C entry point, launch-info entry point) of csrc/grid_tail_bwd.cu,
    built and bound once."""
    lib = cuda_build.load("grid_tail_bwd")
    fn = lib.mst_grid_tail_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + _SCALES + [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info_fn = lib.mst_grid_tail_bwd_info
    info_fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    info_fn.restype = ctypes.c_int
    return fn, info_fn


@functools.cache
def bwd_launch_info(index: int, form) -> tuple:
    """K3's launch info on card ``index`` in one form (``form``: the dtype
    of xo): (dynamic shared memory bytes, threads per block, resident
    blocks per SM, rows per tile). The first call on a card sets the
    kernels' shared-memory limit there, so each card gets its own."""
    _, info_fn = _bwd_entry()
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        rc = info_fn(int(form == BF16), info)
    if rc != 0:
        raise RuntimeError(f"grid tail backward kernel: CUDA error {rc}")
    return tuple(info)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_grid(n: int, blocks_per_sm: int, sms: int, rows_per_tile: int) -> int:
    """K3's grid for ``n`` rows: as many blocks as the card holds, at most
    one per tile. Block b takes tiles b, b + grid, b + 2 grid, ... and
    writes one ct_w partial."""
    return min(blocks_per_sm * sms, -(-n // rows_per_tile))


def _slope(dtype):
    return _SLOPE_BF16 if dtype == BF16 else _SLOPE


def _leaky(x):
    """LR at x's dtype: a bf16 x gives ``bf16(bf16(0.01) * x)`` below 0."""
    if x.dtype == BF16:
        return torch.where(x > 0, x, x * _SLOPE_BF16)
    return F.leaky_relu(x, _SLOPE)


def _dleaky_mul(x, ct):
    """dLR(x) * ct without forming the derivative (pallas_grid._dleaky_mul),
    at ct's dtype."""
    return torch.where(x >= 0, ct, ct * _slope(ct.dtype))


@uncounted()
def grid_tail_plain(xo, xd, w, rest, scale: Sequence[float]):
    """Plain torch version. ``xo``: (*L, O, K), ``xd``: (*L, D, K), ``w``:
    (K, F), ``rest``: broadcastable to (*L, O*D, F), ``scale``: F floats.
    Returns (*L, O*D, F) at xo's dtype. Each output sums its K terms in
    ascending k, one rounded multiply and one rounded add per term, and
    only (*L, O, D, F) sums are ever held — the grid itself is formed one
    k-slice at a time.

    The bf16 form (bf16 ``xo``/``xd``, fp32 ``w``/``rest``) rounds where
    jax.make_jaxpr of ``_tail_jnp`` on bf16 inputs does: LR(xo), LR(xd),
    their sum and its LR are bf16 (each operation rounded once, the slope
    bf16(0.01)); the grid converts to fp32 for ``grid * w`` and the K-sum,
    the sigmoid and the scale are fp32; the output rounds once to bf16
    (the applier's cast_storage)."""
    *lead, O, K = xo.shape
    D = xd.shape[-2]
    n_feat = w.shape[-1]
    a_o = _leaky(xo)
    a_d = _leaky(xd)
    y = torch.zeros(*lead, O, D, n_feat, dtype=w.dtype, device=xo.device)
    for k in range(K):
        g = _leaky(a_o[..., :, None, k] + a_d[..., None, :, k])
        y = y + g.to(w.dtype)[..., None] * w[k]
    y = y.reshape(*lead, O * D, n_feat)
    sc = torch.tensor(list(scale), dtype=y.dtype, device=y.device)
    return (torch.sigmoid(y + rest) * sc).to(xo.dtype)


@uncounted()
def grid_tail_bwd_plain(xo, xd, out, ct, w, scale: Sequence[float]):
    """Plain torch version of K3, from the formulas of ``_bwd_kernel``
    (pallas_grid.py:167-194). ``xo`` (*L, O, K), ``xd`` (*L, D, K), ``out``
    and ``ct`` (*L, O*D, F), ``w`` (K, F). Returns (ct_xo, ct_xd, ct_y,
    ct_w): ct_y (*L, O*D, F) is the cotangent of ``rest`` at full shape.
    ct_G sums its F terms in ascending f, ct_xo its D terms in ascending d
    and ct_xd its O terms in ascending o, one rounded operation at a time,
    as the kernel does; ct_w, a sum over every row, is one matrix product.

    The bf16 form (bf16 ``xo``, ``xd``, ``out`` and ``ct``) returns ct_xo
    and ct_xd as bf16 and ct_y and ct_w as fp32, JAX's dtypes. It rounds
    where the jaxpr of ``jax.grad`` of ``_tail_jnp`` on bf16 inputs does:
    gp and LR(gp) as in the forward; ct_G (an fp32 sum over f) to bf16;
    dLR(gp) * ct_G and dLR(x) * sum at bf16 (the slope bf16(0.01)); the sums
    over d and over o, bf16 reduce_sums in the jaxpr, accumulate in fp32 and
    round once. One choice differs from JAX: JAX's checkpointed backward
    recomputes the fp32 output for the sigmoid's derivative, while this
    form takes s from the saved bf16 output (s = out * (1 / scale)), so
    s * (1 - s) carries the output's bf16 rounding
    (tests/test_torch_kernels.py measures what that costs against JAX)."""
    *lead, O, K = xo.shape
    D = xd.shape[-2]
    n_feat = w.shape[-1]
    n = math.prod(lead)
    sc = torch.tensor(list(scale), dtype=w.dtype, device=out.device)
    s = out.to(w.dtype) * (1.0 / sc)
    ct_y = ct.to(w.dtype) * (sc * s * (1.0 - s))      # d sigmoid
    ct_y4 = ct_y.reshape(n, O, D, n_feat)
    xo3 = xo.reshape(n, O, K)
    xd3 = xd.reshape(n, D, K)
    gp = _leaky(xo3)[:, :, None, :] + _leaky(xd3)[:, None, :, :]
    ct_g = ct_y4[..., 0:1] * w[:, 0]                  # (n, O, D, K)
    for f in range(1, n_feat):
        ct_g = ct_g + ct_y4[..., f:f + 1] * w[:, f]
    ct_gp = _dleaky_mul(gp, ct_g.to(xo.dtype)).to(w.dtype)
    sum_d = ct_gp[:, :, 0]
    for d in range(1, D):
        sum_d = sum_d + ct_gp[:, :, d]
    sum_o = ct_gp[:, 0]
    for o in range(1, O):
        sum_o = sum_o + ct_gp[:, o]
    ct_xo = _dleaky_mul(xo3, sum_d.to(xo.dtype))
    ct_xd = _dleaky_mul(xd3, sum_o.to(xo.dtype))
    ct_w = _leaky(gp).to(w.dtype).reshape(-1, K).t() \
        @ ct_y4.reshape(-1, n_feat)
    return (ct_xo.reshape(xo.shape), ct_xd.reshape(xd.shape), ct_y, ct_w)


def _rest_layout(lead, rest_shape):
    """(rest_rep, rest_inner) telling the kernel which rest row each output
    row reads: rest of the full lead shape maps row to row; rest with a
    size-1 channel axis (dim 1) is shared by that axis' rows."""
    lead = tuple(lead)
    tail = (N_OCTAVES * N_SCALE_DEGREES, N_FEATURES)
    if tuple(rest_shape) == lead + tail:
        return 1, 1
    if (len(lead) >= 2 and tuple(rest_shape) == (lead[0], 1) + lead[2:] + tail):
        return lead[1], math.prod(lead[2:])
    raise ValueError(f"grid_tail: rest {tuple(rest_shape)} must be "
                     f"{lead + tail} or broadcast over dim 1 of it")


def _check_widths(xo, xd, w, scale):
    """The lead dims, after checking (O, D, K, F) and the scales."""
    *lead, O, K = xo.shape
    want = (N_OCTAVES, N_SCALE_DEGREES, GRID_DEPTH, N_FEATURES)
    got = (O, xd.shape[-2], K, w.shape[-1])
    if got != want or tuple(xd.shape[:-2]) != tuple(lead) \
            or tuple(w.shape) != (GRID_DEPTH, N_FEATURES):
        raise ValueError(f"grid_tail: (O, D, K, F) must be {want}, got "
                         f"xo {tuple(xo.shape)}, xd {tuple(xd.shape)}, "
                         f"w {tuple(w.shape)}")
    if len(scale) != N_FEATURES:
        raise ValueError(f"grid_tail: {len(scale)} scales for "
                         f"{N_FEATURES} features")
    return tuple(lead)


def _check_dtypes(xo, xd, w, rest=None, saved=()):
    """The form these inputs take, fp32 or bf16: ``xo``, ``xd`` and the
    ``saved`` tensors (the output and its cotangent) at one of the two,
    ``w`` and ``rest`` fp32. Any other dtype raises."""
    form = xo.dtype
    if form not in (FP32, BF16):
        raise ValueError(f"grid_tail: xo is {form}; the kernel takes "
                         f"float32 or bfloat16")
    for name, t, want in ((("xd", xd, form), ("w", w, FP32))
                          + ((("rest", rest, FP32),) if rest is not None
                             else ())
                          + tuple((n, t, form) for n, t in saved)):
        if t.dtype != want:
            raise ValueError(f"grid_tail: {name} is {t.dtype}; with xo "
                             f"{form} it must be {want}")
    return form


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary, as the bulk
    copies of K2 and K3 need (a view into a larger tensor may start
    elsewhere). Its dtype is checked before and kept."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def grid_tail_fwd(xo, xd, w, rest, scale: Sequence[float]):
    """The K2 wrapper: (*L, 8, 30), (*L, 7, 30), (30, 5) and rest of shape
    (*L, 56, 5) or (L0, 1, *L[2:], 56, 5) -> (*L, 56, 5) at xo's dtype
    (the fp32 or the bf16 form). CPU tensors run ``grid_tail_plain``; CUDA
    tensors run K2 on the current stream, without waiting for the device.
    Records no gradient."""
    lead = _check_widths(xo, xd, w, scale)
    form = _check_dtypes(xo, xd, w, rest)
    if xo.device.type == "cpu":
        return grid_tail_plain(xo, xd, w, rest, scale)
    launch = _entry()
    if not xo.is_cuda:
        raise ValueError(f"grid_tail: unsupported device {xo.device}")
    rest_rep, rest_inner = _rest_layout(lead, rest.shape)
    ins = [_aligned(t) for t in (xo, xd, w, rest)]
    n = math.prod(lead)
    out = torch.empty(*lead, N_OCTAVES * N_SCALE_DEGREES, N_FEATURES,
                      dtype=form, device=xo.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(xo.device).cuda_stream
    with torch.cuda.device(xo.device):      # the thread's current card
        rc = launch(*(t.data_ptr() for t in ins), *map(float, scale),
                    out.data_ptr(), n, rest_rep, rest_inner,
                    int(form == BF16), stream)
    if rc != 0:
        raise RuntimeError(f"grid tail kernel launch failed: CUDA error {rc}")
    if form == BF16:
        grid_tail.launches_bf16 += 1
    else:
        grid_tail.launches += 1
    return out


def grid_tail_bwd(xo, xd, out, ct, w, scale: Sequence[float]):
    """The K3 wrapper: the cotangents (ct_xo, ct_xd, ct_y, ct_w) of the tail
    from its inputs ``xo``, ``xd``, ``w``, its output ``out`` and the
    output's cotangent ``ct``, in the fp32 form or the bf16 form (bf16
    ``xo``, ``xd``, ``out`` and ``ct``; ct_xo and ct_xd come back bf16,
    ct_y and ct_w fp32). CPU tensors run ``grid_tail_bwd_plain``; CUDA
    tensors run K3 on the current stream (``bwd_grid`` blocks), whose
    per-block ct_w partials are summed here, without waiting for the
    device."""
    lead = _check_widths(xo, xd, w, scale)
    want = lead + (N_OCTAVES * N_SCALE_DEGREES, N_FEATURES)
    for name, t in (("out", out), ("ct", ct)):
        if tuple(t.shape) != want:
            raise ValueError(f"grid_tail_bwd: {name} {tuple(t.shape)} must "
                             f"be {want}")
    form = _check_dtypes(xo, xd, w, saved=(("out", out), ("ct", ct)))
    if xo.device.type == "cpu":
        return grid_tail_bwd_plain(xo, xd, out, ct, w, scale)
    launch, _ = _bwd_entry()
    if not xo.is_cuda:
        raise ValueError(f"grid_tail_bwd: unsupported device {xo.device}")
    dev = xo.device
    _, _, per_sm, rows_per_tile = bwd_launch_info(dev.index, form)
    ins = [_aligned(t) for t in (xo, xd, out, ct, w)]
    n = math.prod(lead)
    ct_xo, ct_xd = (torch.empty_like(t) for t in ins[:2])
    ct_y = torch.empty(want, dtype=FP32, device=dev)
    if n == 0:
        return ct_xo, ct_xd, ct_y, torch.zeros(GRID_DEPTH, N_FEATURES,
                                               device=dev)
    blocks = bwd_grid(n, per_sm, _sm_count(dev.index), rows_per_tile)
    parts = torch.empty(blocks, GRID_DEPTH, N_FEATURES, dtype=torch.float32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):            # the thread's current card
        rc = launch(*(t.data_ptr() for t in ins), *map(float, scale),
                    ct_xo.data_ptr(), ct_xd.data_ptr(), ct_y.data_ptr(),
                    parts.data_ptr(), n, blocks, int(form == BF16), stream)
    if rc != 0:
        raise RuntimeError(f"grid tail backward kernel launch failed: "
                           f"CUDA error {rc}")
    if form == BF16:
        grid_tail_bwd.launches_bf16 += 1
    else:
        grid_tail_bwd.launches += 1
    return ct_xo, ct_xd, ct_y, parts.sum(dim=0)


class GridTail(torch.autograd.Function):
    """The tail with its gradient: K2 forward, K3 backward (their plain
    versions on the CPU), both in the form of xo's dtype. It saves (xo, xd,
    out, w), the residuals of the JAX custom VJP (pallas_grid.py:231); in
    the bf16 form ``out`` is the bf16 output. ``rest`` of shape (L0, 1, …)
    gets ct_y summed over the channel axis, as autodiff of ``broadcast_to``
    does in the JAX package (:470)."""

    @staticmethod
    def forward(ctx, xo, xd, w, rest, scale):
        _rest_layout(xo.shape[:-2], rest.shape)
        out = grid_tail_fwd(xo, xd, w, rest, scale)
        ctx.save_for_backward(xo, xd, out, w)
        ctx.scale = scale
        ctx.rest_shape = tuple(rest.shape)
        return out

    @staticmethod
    def backward(ctx, ct):
        xo, xd, out, w = ctx.saved_tensors
        ct_xo, ct_xd, ct_y, ct_w = grid_tail_bwd(xo, xd, out, ct, w,
                                                 ctx.scale)
        ct_rest = ct_y
        if tuple(ct_y.shape) != ctx.rest_shape:
            ct_rest = ct_y.sum(dim=1, keepdim=True)
        return ct_xo, ct_xd, ct_w, ct_rest, None


def grid_tail(xo, xd, w, rest, scale: Sequence[float]):
    """The note-grid tail: (*L, 8, 30), (*L, 7, 30), (30, 5) and rest of
    shape (*L, 56, 5) or (L0, 1, *L[2:], 56, 5) -> (*L, 56, 5) at xo's
    dtype (fp32, or bf16 under the bf16 storage policy). When
    autograd records, the output's gradient runs K3 (``GridTail``);
    otherwise K2 runs alone on CUDA tensors, ``grid_tail_plain`` on CPU
    tensors."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xo, xd, w, rest)):
        return GridTail.apply(xo, xd, w, rest, tuple(scale))
    return grid_tail_fwd(xo, xd, w, rest, scale)


grid_tail.launches = 0
grid_tail.launches_bf16 = 0
grid_tail_bwd.launches = 0
grid_tail_bwd.launches_bf16 = 0
