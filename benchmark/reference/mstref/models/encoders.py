"""Encoder modules: channels -> (beats, bars) -> style / melody / rhythm.

Counterpart of mst_tpu/models/encoders.py (parity targets per class:
style/model.py:36-141 channel encoders, :144-200 style, :203-297 melody,
:301-443 rhythm). Widths, layer names, activation placement and the order
of every concat follow the JAX modules, so a flax parameter tree maps onto
these modules leaf for leaf (benchmark.reference.mstref.weights).

Tensor layout throughout: pitched channels (B, C, R, T, F10, N, F) =
(batch, channel, bar, beat, beat_fraction, note, note_features).
"""

from __future__ import annotations

from torch import nn

from benchmark.reference.mstref.models.layers import Conv1d, Dense, leaky_relu, mean_size
from benchmark.reference.mstref.ops.lstm import LSTM, BiLSTM
from benchmark.reference.mstref.ops.shapes import cat_with_broadcast, combine, squash_dims

N_OCTAVES = 8
N_SCALE_DEGREES = 7
N_BEAT_FRACTIONS = 10
N_PITCHED_NOTES = N_OCTAVES * N_SCALE_DEGREES
N_PITCHED_FEATURES = 5
N_UNPITCHED_FEATURES = 2
N_UNPITCHED_NOTES = 47
N_MODES = 2
INSTRUMENT_SIZE = 51


def _flatten_call(module, x, keep: int):
    """Apply a (batch, time, feat) module over flattened leading dims (the
    reference's Distributed wrapper, utils/pytorch.py:28-51)."""
    lead = x.shape[:keep]
    out = module(x.reshape((-1,) + tuple(x.shape[keep:])))
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


class PitchedChannelsEncoder(nn.Module):
    """Parity: style/model.py:36-99."""

    def __init__(self, beat_size: int = 64, bar_size: int = 128,
                 n_instrument_features: int = INSTRUMENT_SIZE):
        super().__init__()
        if bar_size % 2:
            raise ValueError("bar_size must be even")
        conv_in = N_BEAT_FRACTIONS * N_PITCHED_FEATURES
        self.conv_out = mean_size(conv_in, beat_size)
        inst = mean_size(n_instrument_features, beat_size)
        self.beats_conv = Conv1d(conv_in, self.conv_out,
                                 kernel_size=2 * N_SCALE_DEGREES,
                                 stride=N_SCALE_DEGREES, padding=4)
        self.instruments_linear = Dense(n_instrument_features, inst)
        self.linear = Dense(self.conv_out * N_OCTAVES + inst, beat_size)
        self.beats_lstm = LSTM(beat_size, beat_size)
        self.bars_lstm = BiLSTM(beat_size, bar_size // 2, bar_axis=True)

    def forward(self, channels, instruments_features, bar_lengths=None,
                channel_mask=None):
        B, C, R, T = channels.shape[:4]
        # (B,C,R,T,10,56,5) -> swap note/features -> merge (fraction,
        # feature) into conv channels: (B*C*R*T, 50, 56)
        x = channels.transpose(-1, -2)
        x = x.reshape(B * C * R * T, N_BEAT_FRACTIONS * N_PITCHED_FEATURES,
                      x.shape[-1])
        x = leaky_relu(self.beats_conv(x))
        x1 = x.reshape(B, C, R, T, self.conv_out * N_OCTAVES)

        x = leaky_relu(self.instruments_linear(instruments_features))
        x2 = x[:, :, None, None, :].expand(B, C, R, T, x.shape[-1])

        x = leaky_relu(self.linear(cat_with_broadcast([x1, x2], -1)))
        beats = _flatten_call(lambda y: self.beats_lstm(y)[0], x, keep=3)

        x = beats[:, :, :, -1]                        # last beat per bar
        x = combine(x, axis=1, mask=channel_mask,      # pool channels
                    over_bars=True)
        bars = self.bars_lstm(x, bar_lengths)
        return beats, bars


class UnpitchedChannelsEncoder(nn.Module):
    """Parity: style/model.py:102-141."""

    def __init__(self, beat_size: int = 64, bar_size: int = 128):
        super().__init__()
        if bar_size % 2:
            raise ValueError("bar_size must be even")
        self.linear = Dense(
            N_BEAT_FRACTIONS * N_UNPITCHED_FEATURES * N_UNPITCHED_NOTES,
            beat_size)
        self.beats_lstm = LSTM(beat_size, beat_size)
        self.bars_lstm = BiLSTM(beat_size, bar_size // 2, bar_axis=True)

    def forward(self, channels, bar_lengths=None, channel_mask=None):
        B, C, R, T = channels.shape[:4]
        x = channels.transpose(-1, -2)
        x = x.reshape(B, C, R, T, -1)  # merge (fraction, feature, note)
        x = leaky_relu(self.linear(x))
        beats = _flatten_call(lambda y: self.beats_lstm(y)[0], x, keep=3)

        x = beats[:, :, :, -1]
        x = combine(x, axis=1, mask=channel_mask, over_bars=True)
        bars = self.bars_lstm(x, bar_lengths)
        return beats, bars


class StyleEncoder(nn.Module):
    """Parity: style/model.py:144-200."""

    def __init__(self, style_size: int = 256, bar_size: int = 128,
                 n_instrument_features: int = INSTRUMENT_SIZE):
        super().__init__()
        s = style_size
        lstm = mean_size(bar_size, s)
        inst = mean_size(n_instrument_features, s, factor=0.25)
        mode = mean_size(N_MODES, s, factor=0.1)
        bpm = mean_size(s, 1, factor=0.05)
        self.bars_lstm = LSTM(bar_size, lstm, bar_axis=True)
        self.instruments_linear = Dense(n_instrument_features, inst)
        self.mode_linear = Dense(N_MODES, mode)
        self.bpm_linear = Dense(1, bpm)
        self.linear = Dense(lstm + inst + mode + bpm, s)

    def forward(self, bars, instruments_features, mode, bpm,
                bar_lengths=None, channel_mask=None):
        _, x = self.bars_lstm(bars, bar_lengths)      # the last valid bar
        x1 = x[:, None, :]                              # (B, 1, F)
        x2 = leaky_relu(self.instruments_linear(instruments_features))
        x3 = leaky_relu(self.mode_linear(mode))[:, None, :]
        x4 = leaky_relu(self.bpm_linear(bpm[:, None]))[:, None, :]
        x = cat_with_broadcast([x1, x2, x3, x4], -1)    # (B, C, F_total)
        x = leaky_relu(self.linear(x))
        return combine(x, axis=1, mask=channel_mask)    # (B, style)


class MelodyEncoder(nn.Module):
    """Parity: style/model.py:203-297 — the octave (+) scale-degree "note
    generating submodule" builds the 56-note axis by broadcast-adding an
    (octave, k) and a (scale_degree, k) embedding grid."""

    def __init__(self, melody_size: int = 8, beat_size: int = 64,
                 bar_size: int = 128,
                 n_instrument_features: int = INSTRUMENT_SIZE):
        super().__init__()
        m = melody_size
        self.melody_size = m
        beats = mean_size(beat_size, m)
        bars = mean_size(bar_size, m)
        inst = mean_size(n_instrument_features, m, factor=0.25)
        chans = mean_size(N_PITCHED_FEATURES, m)
        self.beats_linear = Dense(beat_size, beats)
        self.bars_linear = Dense(bar_size, bars)
        self.instruments_linear = Dense(n_instrument_features, inst)
        self.octave_linear = Dense(beats + bars + inst, m * N_OCTAVES)
        self.scale_degree_linear = Dense(beats + bars + inst,
                                         m * N_SCALE_DEGREES)
        self.channels_linear = Dense(N_PITCHED_FEATURES, chans)
        self.linear = Dense(m + chans, m)

    def forward(self, beats, bars, channels, instruments, channel_mask=None):
        m = self.melody_size
        x1 = leaky_relu(self.beats_linear(beats))[:, :, :, :, None, :]
        x2 = leaky_relu(self.bars_linear(bars))[:, None, :, None, None, :]
        x3 = leaky_relu(self.instruments_linear(instruments))[
            :, :, None, None, None, :]
        y = cat_with_broadcast([
            x1.expand(tuple(x1.shape[:4]) + (N_BEAT_FRACTIONS, x1.shape[-1])),
            x2, x3], -1)                                # (B,C,R,T,F10,F)

        x = self.octave_linear(y)
        x = x.reshape(tuple(x.shape[:-1]) + (N_OCTAVES, m))
        x1 = leaky_relu(x)[..., :, None, :]
        x = self.scale_degree_linear(y)
        x = x.reshape(tuple(x.shape[:-1]) + (N_SCALE_DEGREES, m))
        x2 = leaky_relu(x)[..., None, :, :]
        x1 = squash_dims(leaky_relu(x1 + x2), 5, 7)

        x2 = leaky_relu(self.channels_linear(channels))
        x = leaky_relu(self.linear(cat_with_broadcast([x1, x2], -1)))
        return combine(x, axis=1, mask=channel_mask, over_bars=True)


class PitchedRhythmEncoder(nn.Module):
    """Parity: style/model.py:301-381."""

    def __init__(self, rhythm_size: int = 32, beat_size: int = 64,
                 bar_size: int = 128,
                 n_instrument_features: int = INSTRUMENT_SIZE):
        super().__init__()
        r = rhythm_size
        nf = N_PITCHED_NOTES * N_PITCHED_FEATURES
        widths = (mean_size(beat_size, r),
                  mean_size(bar_size, r, factor=0.5),
                  mean_size(nf, r, factor=0.1),
                  mean_size(n_instrument_features, r, factor=0.5),
                  mean_size(N_MODES, r, factor=0.25),
                  mean_size(1, r, factor=0.25))
        self.beats_linear = Dense(beat_size, widths[0])
        self.bars_linear = Dense(bar_size, widths[1])
        self.channels_linear = Dense(nf, widths[2])
        self.instruments_linear = Dense(n_instrument_features, widths[3])
        self.mode_linear = Dense(N_MODES, widths[4])
        self.bpm_linear = Dense(1, widths[5])
        self.linear = Dense(sum(widths), r)

    def forward(self, beats, bars, channels, instruments_features, mode, bpm,
                channel_mask=None):
        x1 = leaky_relu(self.beats_linear(beats))[:, :, :, :, None, :]
        x2 = leaky_relu(self.bars_linear(bars))[:, None, :, None, None, :]
        x3 = leaky_relu(self.channels_linear(squash_dims(channels, -2)))
        x4 = leaky_relu(self.instruments_linear(instruments_features))[
            :, :, None, None, None, :]
        x5 = leaky_relu(self.mode_linear(mode))[:, None, None, None, None, :]
        x6 = leaky_relu(self.bpm_linear(bpm[:, None]))[
            :, None, None, None, None, :]
        x = cat_with_broadcast([
            x1.expand(tuple(x3.shape[:5]) + (x1.shape[-1],)),
            x2, x3, x4, x5, x6], -1)
        x = leaky_relu(self.linear(x))
        return combine(x, axis=1, mask=channel_mask,    # (B,R,T,F10,r)
                       over_bars=True)


class UnpitchedRhythmEncoder(nn.Module):
    """Parity: style/model.py:384-443."""

    def __init__(self, rhythm_size: int = 32, beat_size: int = 64,
                 bar_size: int = 128):
        super().__init__()
        r = rhythm_size
        nf = N_UNPITCHED_NOTES * N_UNPITCHED_FEATURES
        widths = (mean_size(beat_size, r),
                  mean_size(bar_size, r, factor=0.5),
                  mean_size(nf, r, factor=0.25),
                  mean_size(1, r, factor=0.25))
        self.beats_linear = Dense(beat_size, widths[0])
        self.bars_linear = Dense(bar_size, widths[1])
        self.channels_linear = Dense(nf, widths[2])
        self.bpm_linear = Dense(1, widths[3])
        self.linear = Dense(sum(widths), r)

    def forward(self, beats, bars, channels, bpm, channel_mask=None):
        x1 = leaky_relu(self.beats_linear(beats))[:, :, :, :, None, :]
        x2 = leaky_relu(self.bars_linear(bars))[:, None, :, None, None, :]
        x3 = leaky_relu(self.channels_linear(squash_dims(channels, -2)))
        x4 = leaky_relu(self.bpm_linear(bpm[:, None]))[
            :, None, None, None, None, :]
        x = cat_with_broadcast([
            x1.expand(tuple(x3.shape[:5]) + (x1.shape[-1],)),
            x2, x3, x4], -1)
        x = leaky_relu(self.linear(x))
        return combine(x, axis=1, mask=channel_mask, over_bars=True)
