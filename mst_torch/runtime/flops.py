"""Matmul-FLOP accounting for MFU numbers.

Counterpart of mst_tpu/runtime/flops.py. The JAX package walks a traced
jaxpr; the port counts while the call runs, under
``torch.utils.flop_counter.FlopCounterMode``: every matmul and convolution
the call dispatches, forward and backward, the recompute of
``torch.utils.checkpoint`` included. An LSTM recurrence, a Python loop of
``precision.matmul`` calls here (mst_torch.ops.lstm), is counted step by
step, which equals JAX's scan trip count times its body. The count is of
what ran: where JAX counts a ``cond`` by its largest branch, the port counts
the branch taken.

Convention (the JAX package's): 1 MAC = 2 FLOPs; elementwise work is
excluded, and so is the optimizer (Adam has no matmul in either framework).

The pitched applier's note-grid tail counts 0 on every route, as in the JAX
package, where no form of it (the Pallas kernels, ``_tail_plain``,
``_tail_jnp``, ``_tail_unrolled``) holds a ``dot_general``. On the card K2
and K3 are kernel launches the counter does not see; on the CPU their plain
versions run inside ``uncounted`` (mst_torch.ops.flop_scope), which takes
back what they add to the counts open on their thread
(``grid_tail_bwd_plain`` forms ct_w as one matrix product).

K5 (mst_torch.ops.melody_kernel) counts the products of the composition
it replaces, the embedding products' ten fraction repeats and the masked
channels' note-grid products included, so the melody encoder counts the
same on the card as on the CPU. K6 (mst_torch.ops.compact_kernel) counts
the block prefix product of the compaction it replaces, one (B G, 128) @
(128, 128) product a note family.

Peaks are the card's published dense rates, keyed by the name
``torch.cuda.get_device_name`` reports. A card or dtype not in the table,
and the CPU, raise: the JAX package falls back to its target chip's
numbers, which here would hide the device.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from mst_torch.ops.flop_scope import uncounted  # noqa: F401

# Dense peak FLOP/s per card, from the data sheet, at a 700 W power limit
# (a card set lower runs slower under load). The port runs strict fp32
# (mst_torch.device.strict_fp32: no TF32 in matmuls or cuDNN), so its fp32
# products run outside the tensor cores: 67 TFLOP/s, not TF32's 495.
PEAK_FLOPS = {
    ("NVIDIA H100 80GB HBM3", "bfloat16"): 989e12,
    ("NVIDIA H100 80GB HBM3", "float32"): 67e12,
}


def _bmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """(B, M, K) @ (B, K, N): 2 B M N K. Takes the ``out_dtype`` overload
    (``torch.bmm(a, b, out_dtype=...)``, the bf16 product on the card),
    which torch's own formula refuses."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[-1] * k


_CUSTOM = {torch.ops.aten.bmm: _bmm_flops}


class _GlobalOnly:
    """Stands in for FlopCounterMode's module tracker: every count goes to
    the global total alone. The tracker hooks the autograd graph of each
    module's outputs, which fails under ``torch.inference_mode`` (the
    serving path), and the per-module breakdown is not read."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class MatmulFlops:
    """Counts the matmul FLOPs of the code run inside it (``.total``, an
    int): on this thread and in the backwards it starts, less what ran
    inside ``uncounted``. Not reentrant."""

    def __init__(self):
        self._counter = FlopCounterMode(display=False,
                                        custom_mapping=_CUSTOM)
        self._counter.mod_tracker = _GlobalOnly()
        self.total = 0

    def __enter__(self):
        self._counter.__enter__()
        return self

    def __exit__(self, *exc):
        self._counter.__exit__(*exc)
        self.total = self._counter.get_total_flops()
        return False


def count_matmul_flops(fn, *args, **kwargs) -> int:
    """Matmul and conv FLOPs of one call ``fn(*args, **kwargs)``.

    The call runs (JAX's counter only traces), with its effects: a train
    step counted this way is a step taken. Its time is not the time of an
    uncounted call, so a caller that times a step times another call than
    the one it counts. Count a request with
    ``count_matmul_flops(transfer_styles, bundle, comps, styles, out)`` on
    an uncaptured bundle, or replay its ``call_log``
    (``replay_log_flops``): a replayed graph runs no Python, so the
    counter sees nothing of it."""
    with MatmulFlops() as count:
        fn(*args, **kwargs)
    return count.total


def _signature(x):
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return x


def replay_log_flops(bundle, call_log) -> int:
    """Matmul FLOPs of a ``ModelBundle.call_log``, a list of ``(key,
    inputs, statics, shard)`` program calls (mst_tpu's ``replay_log_flops``,
    mst_tpu/runtime/flops.py:128-149). Each distinct (key, shapes and
    dtypes of the inputs, statics) runs once more, uncaptured and
    unlogged, on its shard's replica, under the counter; the log's total
    sums over its calls."""
    counts = {}
    total = 0
    for key, inputs, statics, shard in call_log:
        sig = (key, _signature(inputs), tuple(sorted(statics.items())))
        if sig not in counts:
            counts[sig] = count_matmul_flops(bundle.run, key, inputs,
                                             statics, False, shard)
        total += counts[sig]
    return total


def device_peak_flops(compute_dtype="bfloat16", device=None) -> float:
    """The card's dense peak for ``compute_dtype`` ("float32"/"bfloat16"
    or the torch dtype). ``device``: a CUDA device (default the current
    card). The CPU, a card without a GPU present, and a card or dtype not
    in ``PEAK_FLOPS`` raise."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"device_peak_flops: no peak for {device}; the "
                         f"table holds CUDA cards")
    if not torch.cuda.is_available():
        raise RuntimeError("device_peak_flops: no CUDA device")
    name = torch.cuda.get_device_name(device)
    key = (name, str(compute_dtype).removeprefix("torch."))
    if key not in PEAK_FLOPS:
        raise KeyError(f"device_peak_flops: no published peak for {key}; "
                       f"known: {sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[key]


def mfu(flops_per_step: float, seconds_per_step: float,
        compute_dtype="bfloat16", device=None) -> float:
    """Model FLOP utilization: achieved matmul FLOP/s over the card's peak."""
    peak = device_peak_flops(compute_dtype, device)
    return flops_per_step / seconds_per_step / peak
