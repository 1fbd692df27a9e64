"""Style appliers: latents -> dense note tensors.

Counterpart of mst_tpu/models/appliers.py (parity: style/model.py:565-724).
Output activations: duration = 6*sigmoid, velocity = sigmoid, accidentals =
sigmoid (:565-579).

The pitched applier's note-grid tail runs through ops.grid_tail
(K2, ``csrc/grid_tail.cu``, on the card). Its melody term ``mel_c + bias``
stays at (B, 1, R, T, F10, 56, 5): the kernel reads it per song and it is
never expanded over the channel axis. Under a bf16 storage dtype the tail's
embeddings ``xo``/``xd`` and both appliers' outputs are stored as bf16
(mst_tpu/models/appliers.py:79-89,122-123); the tail then runs its bf16
form, which writes its output at bf16 itself.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.mstref.models.layers import (ConcatDense, Dense, DenseParams,
                                     leaky_relu, mean_size)
from benchmark.reference.mstref.ops import precision
from benchmark.reference.mstref.ops.grid_tail import grid_tail

N_OCTAVES = 8
N_SCALE_DEGREES = 7
N_BEAT_FRACTIONS = 10
N_PITCHED_FEATURES = 5
N_UNPITCHED_FEATURES = 2
N_UNPITCHED_NOTES = 47
MAX_DURATION = 6.0
INSTRUMENT_SIZE = 51


class PitchedStyleApplier(nn.Module):
    """Parity: style/model.py:582-675."""

    def __init__(self, style_size: int = 256, melody_size: int = 8,
                 rhythm_size: int = 32,
                 n_instrument_features: int = INSTRUMENT_SIZE):
        super().__init__()
        p = N_PITCHED_FEATURES
        self.linears_out = p * 6
        parts = (mean_size(style_size, p, factor=0.5),
                 mean_size(rhythm_size, p, factor=0.5),
                 mean_size(n_instrument_features, p, factor=0.4))
        mel = mean_size(melody_size, p, factor=3)
        self.style_linear = Dense(style_size, parts[0])
        self.rhythm_linear = Dense(rhythm_size, parts[1])
        self.instruments_linear = Dense(n_instrument_features, parts[2])
        self.octave_linear = ConcatDense(parts, self.linears_out * N_OCTAVES)
        self.scale_degree_linear = ConcatDense(
            parts, self.linears_out * N_SCALE_DEGREES)
        self.melody_linear = Dense(melody_size, mel)
        self.linear = DenseParams(self.linears_out + mel, p)

    def forward(self, style, melody, rhythm, instruments):
        lo = self.linears_out
        x = leaky_relu(self.style_linear(style))
        x1 = x[:, None, None, None, None, :]            # (B,1,1,1,1,F)
        x = leaky_relu(self.rhythm_linear(rhythm))      # (B,R,T,F10,F)
        x2 = x[:, None]                                 # (B,1,R,T,F10,F)
        x = leaky_relu(self.instruments_linear(instruments))
        x3 = x[:, :, None, None, None, :]               # (B,C,1,1,1,F)

        # the octave/degree linears distribute over the implicit concat of
        # (x1, x2, x3): the channel-independent parts never expand over C
        parts = [x1, x2, x3]
        xo = precision.cast_storage(self.octave_linear(parts))
        xo = xo.reshape(tuple(xo.shape[:-1]) + (N_OCTAVES, lo))
        xd = precision.cast_storage(self.scale_degree_linear(parts))
        xd = xd.reshape(tuple(xd.shape[:-1]) + (N_SCALE_DEGREES, lo))

        mel = leaky_relu(self.melody_linear(melody))    # (B,R,T,F10,56,20)

        # the final linear distributes over its [note-grid(30), melody(20)]
        # concat: the melody part contributes at (B,R,T,F10,56,.) and only
        # its 5-feature output meets the channel axis, inside the kernel
        weight, bias = self.linear()
        kernel = weight.t()                             # (50, 5)
        mel_c = precision.matmul(mel, kernel[lo:])[:, None]
        # the tail's output comes at xo's dtype: its bf16 form stores the
        # output as bf16 itself (appliers.py:89's cast_storage, fused)
        return grid_tail(xo, xd, kernel[:lo], mel_c + bias,
                         (MAX_DURATION, 1.0, 1.0, 1.0, 1.0))


class UnpitchedStyleApplier(nn.Module):
    """Parity: style/model.py:678-724 — a single percussion channel."""

    def __init__(self, style_size: int = 256, rhythm_size: int = 32):
        super().__init__()
        u = N_UNPITCHED_FEATURES
        self.style_linear_size = mean_size(style_size, u, factor=0.5)
        rhythm = mean_size(rhythm_size, u, factor=1.0)
        notes_linear_size = u * 4
        self.style_linear = Dense(style_size,
                                  N_BEAT_FRACTIONS * self.style_linear_size)
        self.rhythm_linear = Dense(rhythm_size, rhythm)
        self.notes_linear = ConcatDense(
            (self.style_linear_size, rhythm),
            N_UNPITCHED_NOTES * notes_linear_size)
        self.linear = Dense(notes_linear_size, u)

    def forward(self, style, rhythm):
        x = leaky_relu(self.style_linear(style))
        x1 = x.reshape(x.shape[0], 1, 1, N_BEAT_FRACTIONS,
                       self.style_linear_size)
        x2 = leaky_relu(self.rhythm_linear(rhythm))      # (B,R,T,F10,F)

        # distributed concat: the per-song style part multiplies once per
        # beat fraction, not per (bar, beat) cell
        x = leaky_relu(self.notes_linear([x1, x2]))      # (B,R,T,F10,.)
        x = x.reshape(tuple(x.shape[:4]) + (N_UNPITCHED_NOTES, -1))
        x = self.linear(x)                               # (B,R,T,F10,47,2)

        # duration = 6*sigmoid, velocity = sigmoid — one fused scale, made
        # on the device (a host tensor copied in would wait for the card,
        # and a CUDA graph capture refuses the copy)
        scale = torch.where(torch.arange(2, device=x.device) == 0,
                            MAX_DURATION, 1.0).to(x.dtype)
        x = precision.cast_storage(torch.sigmoid(x) * scale)
        return x[:, None]                                # (B,1,R,T,F10,47,2)
