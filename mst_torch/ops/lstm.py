"""Batch-first LSTMs: one input projection for all steps + a lean recurrence.

Counterpart of mst_tpu/ops/lstm.py (which replaces the reference's nn.LSTM /
TimeDistributed stacks, style/utils/pytorch.py:19-51). Parameters carry
nn.LSTM's names and layouts — ``weight_ih_l0`` (4H, D), ``weight_hh_l0``
(4H, H), ``bias_ih_l0`` and ``bias_hh_l0`` (4H), with ``_reverse`` for the
backward direction — and gate order (i, f, g, o). The arithmetic follows the
JAX scan step for step: ``x @ W_ih^T + (b_ih + b_hh)`` for every step at
once, then per step ``gates = gx + h @ W_hh^T``. The JAX package has no
Pallas kernel here (its recurrence is a ``lax.scan``). On the card the
recurrence is K4, one hand-written CUDA kernel that runs every step
(mst_torch.ops.lstm_kernel): where no gradient is needed (serving) its
plain form, and where autograd records (training's step) its training
form, which saves the gates of every step for K4's backward kernel
(``lstm_kernel.lstm_recur_train``). On the CPU it is a Python loop of
plain tensor ops, ``lstm_kernel.recur_plain``. Both products run under
the compute dtype (mst_torch.ops.precision), with W_hh cast once before
the loop; the carries stay fp32 even when ``x`` arrives at a bf16 storage
dtype (mst_tpu/ops/lstm.py:91-127,180-184).

A fresh module draws every leaf from U(+-1/sqrt(H)), torch.nn.LSTM's init
and mst_tpu's (ops/lstm.py:53-75), through ``reset_parameters``.

Padded sequences: final states are read at ``lengths-1``; the bidirectional
layer runs its backward direction over a per-row flipped valid prefix
(masked_flip), so padding never enters the backward carry
(mst_tpu/ops/lstm.py:255-258).

Bar-sharded training (mst_torch.ops.seq_context): a module built with
``bar_axis=True`` scans the bar axis. Under an active sequence-sharding
context its input holds this rank's bars, the input projection stays
local and the recurrence runs as
``mst_torch.parallel.seq_lstm.seq_sharded_scan``, each direction of a
BiLSTM on its own (mst_tpu/ops/lstm.py:94-104,229-244); the final-state
read and the per-row flip cross ranks through seq_context. The beat-axis
modules (a bar never spans ranks) always run locally.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mst_torch.ops import precision
from mst_torch.ops.init import uniform_
from mst_torch.ops.lstm_kernel import (lstm_recur, lstm_recur_train,
                                       recur_plain)
from mst_torch.ops.seq_context import (count_once, current_seq_mesh,
                                       last_step, masked_flip_bars)
from mst_torch.ops.shapes import masked_flip


def _direction_params(module: nn.Module, suffix: str, input_size: int,
                      features: int) -> None:
    h = features
    module.register_parameter(f"weight_ih_l0{suffix}", nn.Parameter(
        torch.zeros(4 * h, input_size)))
    module.register_parameter(f"weight_hh_l0{suffix}", nn.Parameter(
        torch.zeros(4 * h, h)))
    module.register_parameter(f"bias_ih_l0{suffix}", nn.Parameter(
        torch.zeros(4 * h)))
    module.register_parameter(f"bias_hh_l0{suffix}", nn.Parameter(
        torch.zeros(4 * h)))


def _reset_lstm(module: nn.Module, generator: torch.Generator) -> None:
    """Every leaf U(+-1/sqrt(H)), in registration order."""
    bound = 1.0 / module.features ** 0.5
    for param in module.parameters():
        uniform_(param, bound, generator)


def _projected(module: nn.Module, suffix: str, x):
    """(N, T, D) -> the input half of the gates for every step, (N, T, 4H)."""
    w_ih = getattr(module, f"weight_ih_l0{suffix}")
    b = (getattr(module, f"bias_ih_l0{suffix}")
         + getattr(module, f"bias_hh_l0{suffix}"))
    return precision.matmul(x, w_ih.t()) + b


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _recur(gates_x, w_hh_t):
    """Run the recurrence. ``gates_x``: (K, N, T, 4H) for K independent
    directions, ``w_hh_t``: (K, H, 4H). Returns outputs (K, N, T, H).
    CUDA tensors run K4, one launch for every step
    (mst_torch.ops.lstm_kernel): where no gradient is needed (serving,
    under ``torch.inference_mode``) its plain form, where autograd records
    (training) its training form and, in the backward, K4's backward
    kernel. The CPU runs the loop."""
    if not gates_x.is_cuda:
        return recur_plain(gates_x, w_hh_t)
    if _needs_grad(gates_x, w_hh_t):
        return lstm_recur_train(gates_x, w_hh_t)
    return lstm_recur(gates_x, w_hh_t)


def _sharded_scan(gates_x, w_hh_t, mesh, reverse: bool = False):
    # imported here: parallel.seq_lstm imports this module
    from mst_torch.parallel.seq_lstm import seq_sharded_scan
    # the scan gives every seq rank the whole w_hh gradient; the step sums
    # the gradients over the mesh, so it counts from seq rank 0 alone
    w_hh_t, = count_once(w_hh_t)
    return seq_sharded_scan(gates_x, w_hh_t, mesh, reverse=reverse)


def _bar_mesh(module):
    """The sequence-sharding mesh when ``module`` scans the bar axis."""
    return current_seq_mesh() if module.bar_axis else None


class LSTM(nn.Module):
    """Unidirectional batch-first LSTM returning (outputs, last valid step).
    ``bar_axis``: it scans the bar axis (module docstring)."""

    def __init__(self, input_size: int, features: int,
                 bar_axis: bool = False):
        super().__init__()
        self.features = features
        self.bar_axis = bar_axis
        _direction_params(self, "", input_size, features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_lstm(self, generator)

    def forward(self, x, lengths: Optional[torch.Tensor] = None):
        gates_x = _projected(self, "", x)
        mesh = _bar_mesh(self)
        if mesh is None:
            out = _recur(gates_x[None], self.weight_hh_l0.t()[None])[0]
        else:
            out = _sharded_scan(gates_x, self.weight_hh_l0.t(), mesh)
        return out, last_step(out, lengths)


class BiLSTM(nn.Module):
    """Bidirectional batch-first LSTM; output feature dim = 2*features. Both
    directions run in one loop as a batch of two (mst_tpu's merged scan),
    apart from the bar-sharded path. ``bar_axis``: as ``LSTM``'s."""

    def __init__(self, input_size: int, features: int,
                 bar_axis: bool = False):
        super().__init__()
        self.features = features
        self.bar_axis = bar_axis
        _direction_params(self, "", input_size, features)
        _direction_params(self, "_reverse", input_size, features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_lstm(self, generator)

    def forward(self, x, lengths: Optional[torch.Tensor] = None):
        mesh = _bar_mesh(self)
        if mesh is not None:
            return self._sharded(x, lengths, mesh)
        if lengths is None:
            flipped = torch.flip(x, dims=(1,))
        else:
            flipped = masked_flip(x, lengths)
        gates = torch.stack([_projected(self, "", x),
                             _projected(self, "_reverse", flipped)])
        w_hh_t = torch.stack([self.weight_hh_l0.t(),
                              self.weight_hh_l0_reverse.t()])
        fwd, bwd_raw = _recur(gates, w_hh_t)
        if lengths is None:
            bwd = torch.flip(bwd_raw, dims=(1,))
        else:
            bwd = masked_flip(bwd_raw, lengths)
        return torch.cat([fwd, bwd], dim=-1)

    def _sharded(self, x, lengths, mesh):
        """Each direction as its own seq-sharded recurrence on this rank's
        bars: the backward one right to left from the last rank, or over
        the flipped valid prefix of each row, which spans ranks."""
        w_b = self.weight_hh_l0_reverse.t()
        fwd = _sharded_scan(_projected(self, "", x), self.weight_hh_l0.t(),
                            mesh)
        if lengths is None:
            bwd = _sharded_scan(_projected(self, "_reverse", x), w_b, mesh,
                                reverse=True)
        else:
            flipped = masked_flip_bars(x, lengths)
            bwd = masked_flip_bars(_sharded_scan(
                _projected(self, "_reverse", flipped), w_b, mesh), lengths)
        return torch.cat([fwd, bwd], dim=-1)
