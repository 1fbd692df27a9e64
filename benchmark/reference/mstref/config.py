"""Typed configuration of the representation, the model, training and the
process mesh (a copy of mst_tpu/config.py's dataclasses).

The reference scatters configuration over module-level constants
(train-model.py:33-60, style/model.py:11-28, style/midi_conversion.py:349-369,
style/data.py:19-31). Here everything lives in frozen dataclasses so configs are
hashable (usable as jit static args) and explicit.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RepresentationConfig:
    """Constants of the piano-roll representation.

    Parity: style/model.py:13-19 (n_beat_fractions=10, n_pitched_features=5,
    n_unpitched_features=2, n_octaves=8, n_scale_degrees=7, n_unpitched_notes=47)
    and style/midi_conversion.py:350-369 (beat_divisors=(8,3), percussion 35..81).
    """

    beat_divisors: Tuple[int, ...] = (8, 3)
    n_octaves: int = 8
    n_scale_degrees: int = 7
    min_percussion: int = 35
    max_percussion: int = 81
    n_pitched_features: int = 5   # duration, velocity, flat, natural, sharp
    n_unpitched_features: int = 2  # duration, velocity

    @property
    def beat_fractions(self) -> Tuple[Fraction, ...]:
        """Sorted distinct onset fractions within a beat (midi_conversion.py:358-362)."""
        return tuple(sorted({
            Fraction(i, d) for d in self.beat_divisors for i in range(d)
        }))

    @property
    def n_beat_fractions(self) -> int:
        return len(self.beat_fractions)

    @property
    def n_pitched_notes(self) -> int:
        return self.n_octaves * self.n_scale_degrees

    @property
    def n_unpitched_notes(self) -> int:
        return self.max_percussion - self.min_percussion + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (parity: train-model.py:54-60, style/model.py:20-27)."""

    beat_size: int = 64
    bar_size: int = 128
    n_rhythm_features: int = 8
    style_size: int = 256
    melody_size: int = 8
    rhythm_size: int = 32

    n_modes: int = 2
    min_bpm: float = 50.0
    max_bpm: float = 200.0
    mean_type: str = "quadratic"

    # numeric policy (benchmark.reference.mstref.ops.precision; mst_tpu/config.py:69-82).
    # Parameters, gradients and the optimizer state stay float32 under both.
    # "bfloat16" compute: matmul and conv operands are cast to bf16, products
    # accumulate in fp32 (the train step and every transfer stage).
    compute_dtype: str = "float32"
    # "bfloat16" storage: the grid-scale activations (every leaky_relu
    # output, the applier outputs, the raster fed to the model and the
    # losses) are stored as bf16. Training only; serving narrows at most its
    # extraction stage (transfer.ModelBundle.extract_storage_dtype).
    storage_dtype: str = "float32"

    @property
    def bpm_range(self) -> float:
        return self.max_bpm - self.min_bpm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (parity: train-model.py:33-41,89-90,97-160;
    a copy of mst_tpu/config.py:89-119)."""

    n_iterations: int = 5000
    iter_size: int = 2             # gradient-accumulation span (summed, not averaged)
    remat: bool = False            # recompute the forward in backward
    #   (torch.utils.checkpoint). The JAX package measured on the v5e that
    #   this does not lower the peak for this model — the per-note broadcast
    #   chains make the forward transient working set the peak, which
    #   recompute cannot shrink; batch_cell_budget is the memory lever.
    learning_rate: float = 1e-2
    lr_decay_every: int = 200      # optimizer steps between decays (StepLR step_size)
    lr_decay_gamma: float = 0.9
    seed: int = 108
    max_total_bars: int = 800      # max_n_bars = max_total_bars // n_channels
    save_interval: int = 100
    min_n_messages: int = 100      # channel filter (style/data.py:51)

    # additions of the batched trainer (absent in the single-song-per-step
    # reference)
    batch_size: int = 1            # songs per step
    prefetch_depth: int = 2        # host batch-building queue depth
    bar_buckets: Tuple[int, ...] = (64, 128, 256, 512, 800)
    channel_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    # batched training only: cap B*C_bucket*R_bucket*T so one padded batch's
    # activations fit device memory (8 songs x 8 channels x 128 bars x 4
    # beats); songs beyond the cap truncate, consistent with the
    # reference's max_total_bars rule.
    batch_cell_budget: int = 8 * 8 * 128 * 4


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh layout (benchmark.reference.mstref.parallel.mesh). ``data`` shards the
    song batch over ranks (the loss sums and the gradients are all-reduced
    over it); ``seq`` shards the bar axis (the LSTM carry is handed from
    rank to rank, benchmark.reference.mstref.parallel.seq_lstm). The axes are named
    ``data`` and ``seq``; mst_tpu's ``data_axis`` and ``seq_axis`` fields,
    which nothing reads there either, are left out."""

    data_parallel: int = -1  # -1: every rank on the data axis
    seq_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    rep: RepresentationConfig = dataclasses.field(
        default_factory=RepresentationConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
