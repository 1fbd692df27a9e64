"""Numeric policy: the matmul compute dtype and the activation storage dtype.

Counterpart of mst_tpu/ops/precision.py. Two independent settings, both
read at call time (torch runs eagerly, so there is nothing to trace):

- ``compute_dtype``: with bfloat16, the operands of every matmul and conv
  are cast to bf16. Matmul products accumulate in fp32 and the result is
  fp32 (JAX's ``preferred_element_type=jnp.float32``); the conv runs
  wholly in bf16 and its output is cast back to fp32, as
  ``precision.conv_general_dilated`` does.
- ``storage_dtype``: with bfloat16, the grid-scale activations are stored
  as bf16 at the points where ``cast_storage`` is applied (every
  ``leaky_relu`` output, the applier outputs, the raster). Parameters,
  gradients, the optimizer state, the LSTM carries and the loss
  reductions stay fp32.

This is not ``torch.autocast``: autocast rounds matmul outputs to bf16 and
picks its own list of ops. The policy here is explicit, as the JAX
package's is. Entry points that own a config (``runtime.train``'s step,
``transfer.ModelBundle``) enter ``precision(...)`` around their work. The
setting lives in a context variable, so threads do not see each other's;
outside any context it is fp32 and fp32. There are no process-wide
setters (mst_tpu's ``set_compute_dtype``/``set_storage_dtype``): every
caller enters the context from its config. No backward reads the policy:
the CUDA autograd engine runs backwards on a thread of its own.

torch does not promote dtypes in ``matmul`` or ``conv1d`` as ``jnp`` does
(bf16 @ fp32 -> fp32), so under fp32 compute a bf16-stored operand is cast
up here before the product. The JAX package's ``einsum`` serves only the
LSTM input projection ("ntd,dk->ntk"), which is ``matmul`` here.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

FP32 = torch.float32
BF16 = torch.bfloat16
FP8 = torch.float8_e4m3fn
_DTYPES = {"float32": FP32, "bfloat16": BF16, "float8_e4m3fn": FP8}

# (compute dtype, storage dtype)
_POLICY = contextvars.ContextVar("mstref_precision", default=(FP32, FP32))


def as_dtype(dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or the torch dtype) -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPES.values():
            return dtype
    elif dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"precision: unsupported dtype {dtype!r}; want one of "
                     f"{sorted(_DTYPES)}")


def compute_dtype() -> torch.dtype:
    return _POLICY.get()[0]


def storage_dtype() -> torch.dtype:
    return _POLICY.get()[1]


@contextlib.contextmanager
def precision(dtype, storage=None):
    """The policy for the code inside. ``dtype``: the matmul compute dtype.
    ``storage``: the activation storage dtype; ``None`` leaves the current
    one as it is."""
    store = storage_dtype() if storage is None else as_dtype(storage)
    token = _POLICY.set((as_dtype(dtype), store))
    try:
        yield
    finally:
        _POLICY.reset(token)


def bf16_value(x: float) -> float:
    """The float value of ``x`` rounded to bf16 (JAX multiplies a bf16
    tensor by a Python scalar in bf16: ``0.01 * x`` is ``bf16(0.01) * x``)."""
    return float(torch.tensor(x, dtype=BF16))


def cast_storage(x):
    """Round one fp32 activation to the storage dtype (a no-op under fp32;
    other dtypes pass through)."""
    store = storage_dtype()
    if store == FP32 or x.dtype != FP32:
        return x
    return x.to(store)


def fp8_values(x):
    """``x`` rounded to e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest value), held in fp32; the gradient passes
    straight through. The benchmark's control of a bf16 configuration
    computes its products on such operands."""
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(FP8).to(FP32) / scale
    return x + (q - x).detach()


def cast_operand(x):
    """Cast one matmul operand to the compute dtype (no-op under fp32)."""
    compute = compute_dtype()
    if compute == FP8:
        return fp8_values(x.to(FP32))
    return x if compute == FP32 else x.to(compute)


def _promoted(*operands):
    dtype = operands[0].dtype
    for o in operands[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return [o.to(dtype) for o in operands]


def _rounded_up(x):
    """bf16 values held as fp32: a product of two is exact in fp32."""
    return x.to(BF16).to(FP32)


class _Bf16Product(torch.autograd.Function):
    """``a @ b`` of bf16 operands, fp32 result, for (M, K) @ (K, N) or
    (B, M, K) @ (B, K, N). On the card the product is ``torch.mm``/``bmm``
    with ``out_dtype=torch.float32``; on the CPU it is the fp32 product of
    the bf16 values (exact products, fp32 sums: the same function up to the
    order of the sums). The backward follows JAX's transposes of a
    ``preferred_element_type=float32`` dot: the fp32 cotangent times the
    other bf16 operand in fp32, rounded to bf16, then cast to the input's
    dtype. An operand that needs no gradient (a raster, a constant) gets
    none, as JAX transposes only the operands it differentiates."""

    @staticmethod
    def forward(ctx, a, b):
        ab, bb = a.to(BF16), b.to(BF16)
        ctx.save_for_backward(ab, bb)
        ctx.dtypes = (a.dtype, b.dtype)
        if ab.is_cuda:
            product = torch.mm if ab.dim() == 2 else torch.bmm
            return product(ab, bb, out_dtype=FP32)
        return torch.matmul(ab.to(FP32), bb.to(FP32))

    @staticmethod
    def backward(ctx, ct):
        ab, bb = ctx.saved_tensors
        ct = ct.to(FP32)
        ct_a = ct_b = None
        if ctx.needs_input_grad[0]:
            ct_a = torch.matmul(ct, bb.to(FP32).transpose(-1, -2))
            ct_a = ct_a.to(BF16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            ct_b = torch.matmul(ab.to(FP32).transpose(-1, -2), ct)
            ct_b = ct_b.to(BF16).to(ctx.dtypes[1])
        return ct_a, ct_b


def matmul(x, w):
    """``x @ w`` under the compute dtype. ``w`` is (K, N) and ``x``
    (..., K), or both are (B, ., .). Under bf16 the operands round to bf16
    and the result is fp32."""
    if compute_dtype() == FP32:
        return torch.matmul(*_promoted(x, w))
    if compute_dtype() == FP8:
        return torch.matmul(fp8_values(x.to(FP32)), fp8_values(w.to(FP32)))
    if w.dim() == 2:
        out = _Bf16Product.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return _Bf16Product.apply(x, w)


def conv1d(x, weight, **kwargs):
    """``F.conv1d`` under the compute dtype (``conv_general_dilated`` of the
    JAX package). Under fp32 a bf16-stored input is first cast to the
    weight's dtype. Under bf16 the conv runs wholly in bf16 and its output
    is cast back to fp32: on the card as a bf16 convolution, on the CPU as
    the fp32 convolution of the bf16 values rounded once to bf16 (fp32
    accumulation and one rounding of the output either way)."""
    if compute_dtype() == FP32:
        if x.dtype != weight.dtype:
            x = x.to(weight.dtype)
        return F.conv1d(x, weight, **kwargs)
    if compute_dtype() == FP8:
        return F.conv1d(fp8_values(x.to(FP32)), fp8_values(weight), **kwargs)
    if x.is_cuda:
        return F.conv1d(x.to(BF16), weight.to(BF16), **kwargs).to(FP32)
    out = F.conv1d(_rounded_up(x), _rounded_up(weight), **kwargs)
    return _rounded_up(out)
