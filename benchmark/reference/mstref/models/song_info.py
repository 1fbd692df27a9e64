"""SongInfoModel: predict (instruments, mode, bpm) from style + rhythm latents.

Counterpart of mst_tpu/models/song_info.py (parity: style/model.py:446-562)
— hierarchical LSTMs over the rhythm grid (beats within bars, then bars),
three two-branch heads, bpm squashed to [min_bpm, max_bpm] by a sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.mstref.models.layers import Dense, leaky_relu, mean_size
from benchmark.reference.mstref.ops.lstm import LSTM
from benchmark.reference.mstref.ops.shapes import cat_with_broadcast, squash_dims

N_BEAT_FRACTIONS = 10
N_MODES = 2
MIN_BPM = 50.0
BPM_RANGE = 150.0


class SongInfoModel(nn.Module):

    def __init__(self, n_rhythm_features: int = 8, style_size: int = 256,
                 rhythm_size: int = 32, n_instruments: int = 41):
        super().__init__()
        s, r, nrf = style_size, rhythm_size, n_rhythm_features
        beats_size = mean_size(N_BEAT_FRACTIONS * r, nrf, factor=0.05)
        self.beats_lstm = LSTM(N_BEAT_FRACTIONS * r, beats_size)
        self.bars_lstm = LSTM(beats_size, nrf, bar_axis=True)
        heads = {
            "instruments": (mean_size(s, n_instruments, factor=0.05),
                            mean_size(r, n_instruments, factor=0.25),
                            n_instruments),
            "mode": (mean_size(s, N_MODES, factor=0.01),
                     mean_size(r, N_MODES, factor=0.1), N_MODES),
            "bpm": (mean_size(s, 1, factor=0.01),
                    mean_size(r, 1, factor=0.1), 1),
        }
        for prefix, (s_out, r_out, out) in heads.items():
            self.add_module(f"style_{prefix}_linear", Dense(s, s_out))
            self.add_module(f"rhythm_{prefix}_linear", Dense(nrf, r_out))
            self.add_module(f"{prefix}_linear", Dense(s_out + r_out, out))

    def _head(self, style, rhythm_features, prefix):
        x1 = leaky_relu(getattr(self, f"style_{prefix}_linear")(style))
        x2 = leaky_relu(getattr(self, f"rhythm_{prefix}_linear")(
            rhythm_features))
        return getattr(self, f"{prefix}_linear")(
            cat_with_broadcast([x1, x2], -1))

    def forward(self, style, rhythm, bar_lengths=None):
        # rhythm features (parity :513-519): (B,R,T,F10,r) -> flatten fractions
        x = squash_dims(rhythm, -2)                       # (B,R,T,F10*r)
        B, R = x.shape[:2]
        out, _ = self.beats_lstm(x.reshape((B * R,) + tuple(x.shape[2:])))
        x = out.reshape((B, R) + tuple(out.shape[1:]))[:, :, -1]  # last beat
        _, rhythm_features = self.bars_lstm(x, bar_lengths)  # last valid bar

        instruments = self._head(style, rhythm_features, "instruments")
        mode = self._head(style, rhythm_features, "mode")
        bpm = self._head(style, rhythm_features, "bpm")[:, 0]
        bpm = torch.sigmoid(bpm) * BPM_RANGE + MIN_BPM  # parity :553-555
        return instruments, mode, bpm
