"""Fresh parameter init: torch-default uniform draws from an explicit
generator.

Counterpart of the JAX package's init functions (mst_tpu/models/layers.py
``_uniform``, :26-29, and mst_tpu/ops/lstm.py ``_uniform_init``, :53-56):
every leaf is U(-bound, bound) with bound = 1/sqrt(fan_in) for the linears
and the conv, 1/sqrt(hidden) for the LSTMs. The distributions are the JAX
package's; the values differ, because the random generators differ.

Values are drawn on the CPU from a ``torch.Generator`` and copied to the
parameter's device, so a seed gives the same model on every device.
"""

from __future__ import annotations

import torch


def uniform_(param: torch.Tensor, bound: float,
             generator: torch.Generator) -> None:
    """Fill ``param`` in place with U(-bound, bound) drawn from
    ``generator`` (a CPU generator)."""
    values = torch.empty(param.shape, dtype=param.dtype).uniform_(
        -bound, bound, generator=generator)
    with torch.no_grad():
        param.copy_(values)
