"""The plain reference of the training micro-steps, and the numbers that
judge the served trainer's first steps.

From the same generated MIDI bytes and the same initial weights as the
trainer under test, the reference works out again the songs (the frozen
copy of the port's host code: SMF parse, the corpus filter, key detection,
quantization), the padded batch of each micro-step at the trainer's
buckets and bar caps (dense host rasters, not K1), the model's forward
with the note-grid tail in plain torch, the loss, the backward through
autograd, the summed gradients over ``iter_size`` micro-steps and torch's
Adam at StepLR's rate, under the configuration's numeric policy (fp32
with TF32 off, or the bf16 policy's rounding points, which the frozen
``ops.precision`` states), with parameters, gradients and Adam's state in
fp32. ``lowp="tf32"`` makes it the control of an fp32 configuration;
``lowp="fp8"`` (e4m3 operands with a per-tensor scale, fp32 sums) the
control of a bf16 one.

The numbers compared (``compare``):

- ``loss_gap``: the worst relative gap of a micro-step's total loss;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  one apply over ``1 - beta1``), by the worst leaf: the gap between the
  two norms of a leaf over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``delta_gap``: the parameters' change after the compared applies, in the
  same measure, by the median leaf of those whose first reference gradient
  is at least a thousandth of the median leaf's (the others move by
  round-off alone under Adam). The worst leaf is not steady: a leaf whose
  gradient is a few hundredths of the median leaf's has elements near
  Adam's epsilon, whose steps turn on round-off (one such leaf read 3e-4
  where the others read under 1e-4); ``worst_leaf_delta_gap`` reports it
  beside.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.mstref.config import ModelConfig
from benchmark.reference.mstref.data.pipeline import (
    Song, get_input, get_used_instruments)
from benchmark.reference.mstref.data.taxonomy import INCLUDED_INSTRUMENTS
from benchmark.reference.mstref.io import smf
from benchmark.reference.mstref.io.midi import is_pitched
from benchmark.reference.mstref.models import StyleTransferModel
from benchmark.reference.mstref.ops import losses as L
from benchmark.reference.mstref.ops import precision
from benchmark.reference.mstref.ops.events import read_midi
from benchmark.reference.mstref.ops.shapes import split_note_features

BETAS = (0.9, 0.999)
EPS = 1e-8


def ingest(data: bytes, min_n_messages: int) -> Optional[Song]:
    """One corpus song as the trainer's stream reads it
    (``data.pipeline.iter_inputs``): modelled instruments with at least
    ``min_n_messages`` messages, None without a pitched channel."""
    channels, info = read_midi(smf.parse_midi_bytes(data))
    allowed = set([-1, *INCLUDED_INSTRUMENTS])
    channels = [c for c in channels if c["instrument_id"] in allowed
                and len(c["messages"]) >= min_n_messages]
    if not any(is_pitched(c["instrument_id"]) for c in channels):
        return None
    return get_input(channels, info)


@dataclasses.dataclass
class Batch:
    mode: torch.Tensor
    bpm: torch.Tensor
    pitched: torch.Tensor
    instruments_features: torch.Tensor
    unpitched: Optional[torch.Tensor]
    used_instruments: torch.Tensor
    bar_lengths: torch.Tensor
    channel_mask: torch.Tensor
    uchannel_mask: Optional[torch.Tensor]


def make_batch(songs: Sequence[Song], Cb: int, Rb: int, caps, device
               ) -> Batch:
    """The padded batch of one micro-step (the port's
    ``device_batch_from_songs``, with host rasters)."""
    B = len(songs)
    T = songs[0].beats_per_bar
    pitched = np.zeros((B, Cb, Rb, T, 10, 56, 5), np.float32)
    unpitched = np.zeros((B, 1, Rb, T, 10, 47, 2), np.float32)
    lengths = np.zeros((B,), np.int64)
    instf = np.zeros((B, Cb, 51), np.float32)
    cmask = np.zeros((B, Cb), np.float32)
    umask = np.zeros((B, 1), np.float32)
    mode = np.zeros((B, 2), np.float32)
    bpm = np.zeros((B,), np.float32)
    used = np.zeros((B, 41), np.float32)
    for i, song in enumerate(songs):
        C = min(song.n_channels, Cb)
        R = min(song.n_bars, Rb, caps[i])
        pitched[i, :C, :R] = song.pitched[:C, :R]
        lengths[i] = R
        instf[i, :C] = song.instruments_features[:C]
        cmask[i, :C] = 1.0
        mode[i] = [0.0, 1.0] if song.info.scale.is_minor else [1.0, 0.0]
        bpm[i] = song.info.bpm
        used[i] = get_used_instruments(song.instruments_features[None, :C],
                                       song.has_unpitched)[0]
        if song.has_unpitched:
            unpitched[i, :1, :R] = song.unpitched[:1, :R]
            umask[i, :1] = 1.0
    any_u = any(s.has_unpitched for s in songs)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return Batch(
        mode=t(mode), bpm=t(bpm),
        pitched=t(pitched.reshape(B, Cb, Rb, T, 10, 280)),
        instruments_features=t(instf),
        unpitched=t(unpitched.reshape(B, 1, Rb, T, 10, 94)) if any_u
        else None,
        used_instruments=t(used), bar_lengths=t(lengths, torch.int64),
        channel_mask=t(cmask), uchannel_mask=t(umask) if any_u else None)


def loss_fn(model: StyleTransferModel, batch: Batch):
    """The training objective (the port's ``runtime.train.loss_fn``)."""
    has_u = batch.unpitched is not None
    pitched = split_note_features(batch.pitched, 5)
    unpitched = split_note_features(batch.unpitched, 2)
    (inst, mode, bpm), x_p, x_u = model(
        batch.mode, batch.bpm, pitched, batch.instruments_features,
        unpitched if has_u else None, bar_lengths=batch.bar_lengths,
        channel_mask=batch.channel_mask,
        uchannel_mask=batch.uchannel_mask if has_u else None)
    R = pitched.shape[2]
    bar_mask = (torch.arange(R, device=pitched.device)[None, :]
                < batch.bar_lengths[:, None]).to(pitched.dtype)
    p_mask = batch.channel_mask[:, :, None] * bar_mask[:, None, :]
    u_mask = (batch.uchannel_mask[:, :, None] * bar_mask[:, None, :]
              if has_u else None)
    return L.total_loss(inst, batch.used_instruments, mode, batch.mode, bpm,
                        batch.bpm, x_p, pitched, x_u,
                        unpitched if has_u else None, normalize=True,
                        mean_type="quadratic", pitched_pad_mask=p_mask,
                        unpitched_pad_mask=u_mask)


@contextlib.contextmanager
def policy(config: ModelConfig, lowp: Optional[str]):
    """The configuration's numeric policy (the frozen ``ops.precision``),
    fp32 matmuls and convolutions with TF32 off; ``lowp`` lowers it one
    step for the control: ``"tf32"`` turns TF32 on, ``"fp8"`` rounds every
    matmul and convolution operand to e4m3."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = lowp == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    compute = "float8_e4m3fn" if lowp == "fp8" else config.compute_dtype
    try:
        with precision.precision(compute, storage=config.storage_dtype):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def init_state_dict(shapes: Dict[str, torch.Size], seed: int, device):
    """The benchmark's initial weights: every leaf U(-b, b) with
    b = 1/sqrt(fan_in), fan_in the product of a weight's trailing sizes (a
    bias takes its sibling weight's), drawn in one call from a
    ``torch.Generator`` on ``device`` seeded by ``seed``."""
    names = sorted(shapes)
    total = sum(int(np.prod(shapes[n])) for n in names)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for n in names:
        shape = shapes[n]
        size = int(np.prod(shape))
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
        else:
            sibling = n.replace("bias", "weight")
            fan_in = (int(np.prod(shapes[sibling][1:]))
                      if sibling != n and sibling in shapes
                      and len(shapes[sibling]) >= 2 else size)
        out[n] = (flat[at:at + size] * (1.0 / fan_in ** 0.5)).reshape(shape)
        at += size
    return out


class TrainReference:
    """The reference trainer from ``state_dict`` on ``device``."""

    def __init__(self, config: ModelConfig, train: dict, state_dict,
                 device, lowp: Optional[str] = None):
        self.device = torch.device(device)
        self.config = config
        self.model = StyleTransferModel(config).to(self.device).train()
        self.model.load_state_dict({k: v.to(self.device)
                                    for k, v in state_dict.items()})
        self.train = train
        self.lowp = lowp
        self.opt = torch.optim.Adam(self.model.parameters(),
                                    lr=train["learning_rate"], betas=BETAS,
                                    eps=EPS)
        for p in self.model.parameters():
            p.grad = torch.zeros_like(p)
        self.micro = 0
        self.applies = 0

    def micro_step(self, batch: Batch) -> float:
        """One micro-step: its total loss; Adam applies every
        ``iter_size`` micro-steps with the summed gradients."""
        with policy(self.config, self.lowp):
            batch = dataclasses.replace(
                batch, pitched=precision.cast_storage(batch.pitched),
                unpitched=(None if batch.unpitched is None else
                           precision.cast_storage(batch.unpitched)))
            loss = loss_fn(self.model, batch).total
            loss.backward()
        self.micro += 1
        if self.micro % self.train["iter_size"] == 0:
            rate = self.train["learning_rate"] * self.train[
                "lr_decay_gamma"] ** (self.applies // self.train[
                    "lr_decay_every"])
            for group in self.opt.param_groups:
                group["lr"] = rate
            self.opt.step()
            self.opt.zero_grad(set_to_none=False)
            self.applies += 1
        return float(loss.detach())

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return {n: self.opt.state[p]["exp_avg"].detach().clone()
                for n, p in self.model.named_parameters()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone()
                for n, p in self.model.named_parameters()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gaps(mine: Dict[str, float], ref: Dict[str, float],
              keep=None) -> List[float]:
    """Each leaf's |norm - reference norm| over the larger of the
    reference norm and the median leaf's reference norm."""
    median = float(np.median([ref[k] for k in ref]))
    return [abs(mine[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in ref if keep is None or k in keep]


def compare(losses: List[float], ref_losses: List[float],
            first_grad: Dict[str, torch.Tensor],
            ref_first_grad: Dict[str, torch.Tensor],
            delta: Dict[str, torch.Tensor],
            ref_delta: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The three numbers compared (module docstring)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_losses))
    g, g_ref = _norms(first_grad), _norms(ref_first_grad)
    median = float(np.median(list(g_ref.values())))
    moving = {k for k, v in g_ref.items() if v >= 1e-3 * median}
    deltas = leaf_gaps(_norms(delta), _norms(ref_delta), moving)
    return {
        "loss_gap": loss_gap,
        "grad_gap": max(leaf_gaps(g, g_ref)),
        "delta_gap": float(np.median(deltas)),
        "worst_leaf_delta_gap": max(deltas),
        "leaves_left_out": len(g_ref) - len(moving),
    }
