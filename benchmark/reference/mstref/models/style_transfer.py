"""The composite StyleTransferModel.

Counterpart of mst_tpu/models/style_transfer.py (parity: style/model.py:
727-793) — extract (style, melody, rhythm) latents, predict song info,
apply style. When percussion channels are present, bar and rhythm
embeddings are pooled from both encoder families via the two-tensor combine
(:766-767). Optional ``bar_lengths`` (B,) and channel masks make padded
batches exact, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.mstref.config import ModelConfig
from benchmark.reference.mstref.models.appliers import PitchedStyleApplier, UnpitchedStyleApplier
from benchmark.reference.mstref.models.encoders import (
    INSTRUMENT_SIZE, MelodyEncoder, PitchedChannelsEncoder,
    PitchedRhythmEncoder, StyleEncoder, UnpitchedChannelsEncoder,
    UnpitchedRhythmEncoder)
from benchmark.reference.mstref.models.song_info import SongInfoModel
from benchmark.reference.mstref.ops.shapes import combine_pair, split_note_features


class StyleTransferModel(nn.Module):

    def __init__(self, config: ModelConfig = ModelConfig(),
                 n_instruments: int = 41,
                 n_instrument_features: int = INSTRUMENT_SIZE):
        super().__init__()
        c = config
        self.config = config
        nif = n_instrument_features
        self.pitched_channels_encoder = PitchedChannelsEncoder(
            c.beat_size, c.bar_size, nif)
        self.unpitched_channels_encoder = UnpitchedChannelsEncoder(
            c.beat_size, c.bar_size)
        self.style_encoder = StyleEncoder(c.style_size, c.bar_size, nif)
        self.melody_encoder = MelodyEncoder(c.melody_size, c.beat_size,
                                            c.bar_size, nif)
        self.pitched_rhythm_encoder = PitchedRhythmEncoder(
            c.rhythm_size, c.beat_size, c.bar_size, nif)
        self.unpitched_rhythm_encoder = UnpitchedRhythmEncoder(
            c.rhythm_size, c.beat_size, c.bar_size)
        self.song_info_model = SongInfoModel(
            c.n_rhythm_features, c.style_size, c.rhythm_size, n_instruments)
        self.pitched_style_applier = PitchedStyleApplier(
            c.style_size, c.melody_size, c.rhythm_size, nif)
        self.unpitched_style_applier = UnpitchedStyleApplier(
            c.style_size, c.rhythm_size)

    def init_parameters(self, seed: int) -> "StyleTransferModel":
        """A fresh init from ``seed``: every layer's ``reset_parameters``
        with one CPU ``torch.Generator``, in module order. The draws follow
        the JAX package's init distributions (mst_tpu/models/layers.py,
        ops/lstm.py), not its values. Returns the model."""
        generator = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def extract_style(self, mode, bpm, pitched_channels, instruments_features,
                      unpitched_channels=None, bar_lengths=None,
                      channel_mask=None, uchannel_mask=None):
        """Parity: model.py:751-773. Rasters come either as 7-axis
        (B, C, bar, beat, frac, note, feat) tensors or NF-fused
        (B, C, bar, beat, frac, note*feat), the device rasterizer's layout."""
        pitched_channels = split_note_features(pitched_channels, 5)
        unpitched_channels = split_note_features(unpitched_channels, 2)
        pitched_beats, pitched_bars = self.pitched_channels_encoder(
            pitched_channels, instruments_features, bar_lengths, channel_mask)
        pitched_rhythm = self.pitched_rhythm_encoder(
            pitched_beats, pitched_bars, pitched_channels,
            instruments_features, mode, bpm, channel_mask)

        if unpitched_channels is None:
            bars = pitched_bars
            rhythm = pitched_rhythm
        else:
            unpitched_beats, unpitched_bars = self.unpitched_channels_encoder(
                unpitched_channels, bar_lengths, uchannel_mask)
            unpitched_rhythm = self.unpitched_rhythm_encoder(
                unpitched_beats, unpitched_bars, unpitched_channels, bpm,
                uchannel_mask)
            # in a mixed batch, rows without any percussion channel must see
            # pitched-only embeddings (the reference omits the absent tensor)
            u_present = None
            if uchannel_mask is not None:
                u_present = uchannel_mask.amax(dim=1) > 0
            bars = combine_pair(pitched_bars, unpitched_bars, u_present)
            rhythm = combine_pair(pitched_rhythm, unpitched_rhythm, u_present)

        style = self.style_encoder(bars, instruments_features, mode, bpm,
                                   bar_lengths, channel_mask)
        melody = self.melody_encoder(pitched_beats, pitched_bars,
                                     pitched_channels, instruments_features,
                                     channel_mask)
        return style, melody, rhythm

    def predict_song_info(self, style, rhythm, bar_lengths=None):
        """Parity: model.py:775-777."""
        return self.song_info_model(style, rhythm, bar_lengths)

    def apply_style(self, style, melody, rhythm, instruments_features,
                    unpitched: bool = False):
        """Parity: model.py:779-782."""
        x_pitched = self.pitched_style_applier(style, melody, rhythm,
                                               instruments_features)
        x_unpitched = (self.unpitched_style_applier(style, rhythm)
                       if unpitched else None)
        return x_pitched, x_unpitched

    def forward(self, mode, bpm, pitched_channels, instruments_features,
                unpitched_channels=None, bar_lengths=None, channel_mask=None,
                uchannel_mask=None):
        """Full forward (parity: model.py:784-793)."""
        style, melody, rhythm = self.extract_style(
            mode, bpm, pitched_channels, instruments_features,
            unpitched_channels, bar_lengths, channel_mask, uchannel_mask)
        song_info = self.predict_song_info(style, rhythm, bar_lengths)
        x_pitched, x_unpitched = self.apply_style(
            style, melody, rhythm, instruments_features,
            unpitched_channels is not None)
        return song_info, x_pitched, x_unpitched
