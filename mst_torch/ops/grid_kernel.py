"""K2: the pitched applier's note-grid tail as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``mst_tpu/ops/pallas_grid.py:_fwd_kernel``
(via ``_tail_t_fwd``, :217-231, and ``fused_grid_tail``, :434) and holds the
numerics of the serving path's ``_tail_unrolled`` (:284-310):

    out = sigmoid(sum_k LR(LR(xo)[o,k] + LR(xd)[d,k]) * w[k,f] + rest) * scale

The kernel source is ``csrc/grid_tail.cu``; its header says what bounds it
on the H100 (HBM bytes: the embeddings in, the (…, 56, 5) output out) and
what the design does about it (the (…, 8, 7, 30) grid lives only in
registers; ``rest`` is read per song, never expanded over channels).

``grid_tail`` is the wrapper: CPU tensors take the plain version
``grid_tail_plain``; tensors anywhere else launch the kernel or raise.
``grid_tail.launches`` counts kernel launches. The kernel is built without
FMA contraction, so on the card it agrees with the plain version bit for
bit (``chip_smoke.py`` holds it to that within a stated tolerance).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from mst_torch.ops import cuda_build

N_OCTAVES = 8
N_SCALE_DEGREES = 7
GRID_DEPTH = 30
N_FEATURES = 5


def _entry():
    """The C entry point of csrc/grid_tail.cu (built at first use)."""
    fn = cuda_build.load("grid_tail").mst_grid_tail
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def grid_tail_plain(xo, xd, w, rest, scale: Sequence[float]):
    """Plain torch version. ``xo``: (*L, O, K), ``xd``: (*L, D, K), ``w``:
    (K, F), ``rest``: broadcastable to (*L, O*D, F), ``scale``: F floats.
    Returns (*L, O*D, F). Each output sums its K terms in ascending k, one
    rounded multiply and one rounded add per term, and only (*L, O, D, F)
    sums are ever held — the grid itself is formed one k-slice at a time."""
    *lead, O, K = xo.shape
    D = xd.shape[-2]
    n_feat = w.shape[-1]
    a_o = _leaky(xo)
    a_d = _leaky(xd)
    y = torch.zeros(*lead, O, D, n_feat, dtype=xo.dtype, device=xo.device)
    for k in range(K):
        g = _leaky(a_o[..., :, None, k] + a_d[..., None, :, k])
        y = y + g[..., None] * w[k]
    y = y.reshape(*lead, O * D, n_feat)
    sc = torch.tensor(list(scale), dtype=y.dtype, device=y.device)
    return torch.sigmoid(y + rest) * sc


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


def grid_tail(xo, xd, w, rest, scale: Sequence[float]):
    """The note-grid tail: (*L, 8, 30), (*L, 7, 30), (30, 5) and rest of
    shape (*L, 56, 5) or (L0, 1, *L[2:], 56, 5) -> (*L, 56, 5) fp32.
    CPU tensors run ``grid_tail_plain``; CUDA tensors run K2."""
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
    if xo.device.type == "cpu":
        return grid_tail_plain(xo, xd, w, rest, scale)
    launch = _entry()
    if not xo.is_cuda:
        raise ValueError(f"grid_tail: unsupported device {xo.device}")
    rest_rep, rest_inner = _rest_layout(lead, rest.shape)
    ins = [t.to(torch.float32).contiguous() for t in (xo, xd, w, rest)]
    sc = torch.tensor(list(scale), dtype=torch.float32, device=xo.device)
    n = math.prod(lead)
    out = torch.empty(*lead, N_OCTAVES * N_SCALE_DEGREES, N_FEATURES,
                      dtype=torch.float32, device=xo.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(xo.device).cuda_stream
    rc = launch(*(t.data_ptr() for t in ins), sc.data_ptr(), out.data_ptr(),
                n, rest_rep, rest_inner, stream)
    if rc != 0:
        raise RuntimeError(f"grid tail kernel launch failed: CUDA error {rc}")
    grid_tail.launches += 1
    return out


grid_tail.launches = 0
