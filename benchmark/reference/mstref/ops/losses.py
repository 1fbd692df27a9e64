"""The loss stack: smooth-F1 notes loss, masked regression losses, and the
quadratic-mean hierarchical combination.

Counterpart of mst_tpu/ops/losses.py (parity target: style/model.py:818-997
+ style/utils/pytorch.py:68-94). The reference's value-dependent branches
(safe_sqrt's ``if x == 0``, safe_div's ``if |d| < eps``) are ``torch.where``
on safe operands, as ``jnp.where`` is in the JAX package, so values and
gradients match it at 0 and at NaN. Where JAX's ``minimum``, ``maximum`` and
``clip`` split a gradient evenly at a tie, ``torch.minimum`` and
``torch.maximum`` do the same (``clamp`` would not), so they are used
throughout.

Batched generalization: the losses reduce over the whole batch jointly
(global sums), which is identical at batch=1. ``pad_mask`` zeroes padded
(channel, bar) cells out of every reduction, including the model's own
predictions at padded positions.

Training over ranks: with a process ``group`` (the ranks of the mesh),
each rank holds some rows of the batch and, over a seq axis, some bars of
them; every partial sum (tp, fp and fn, each masked numerator and its
mask sum, each batch mean's numerator and count) is summed over the group
before ``safe_div`` and ``get_mean`` combine them, so every rank computes
the global batch's losses; JAX's GSPMD inserts the same sums. The
per-song means sum over ``song_group`` instead (the data axis: the seq
ranks of one row hold the same songs). That sum's backward is the
identity: each rank backprops the global loss through its own cells
only, and the parameter gradients are then summed over the mesh
(benchmark.reference.mstref.runtime.train). Without a group, or with a group of one rank,
nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

EPSILON = 1e-7  # parity: style/model.py:11
MAX_DURATION = 6.0
BPM_RANGE = 150.0  # max_bpm - min_bpm (style/model.py:22-25)


def _zero(x):
    return x.new_zeros(())


class _GroupSum(torch.autograd.Function):
    """Sum over the ranks of a process group; the backward is the identity
    (each rank's cotangent stays its own). An all-reduce whose backward
    all-reduces the cotangent too would count the gradient once per rank
    when every rank backprops the same global loss."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def _alone(group) -> bool:
    """No group, or a group of this rank alone: nothing to sum."""
    return group is None or dist.get_world_size(group) == 1


def group_sums(group, *partials):
    """The scalar partial sums summed over ``group`` (one all-reduce for
    all of them); alone (``_alone``), as given."""
    if _alone(group):
        return partials
    return tuple(_GroupSum.apply(torch.stack(partials), group).unbind(0))


def _mean(x, group=None):
    """Mean of every element over the group's rows: the summed sum over the
    summed count; alone, ``x.mean()`` itself."""
    if _alone(group):
        return x.mean()
    total, count = group_sums(group, x.sum(), x.new_full((), x.numel()))
    return total / count


def safe_sqrt(x):
    """sqrt with value 0 and gradient 0 at x == 0 (parity: utils/pytorch.py:68-71).

    NaN inputs stay NaN (``NaN > 0`` is False, so a plain where would silently
    map a blown-up loss component to 0.0 and hide it from the NaN guard)."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    out = torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))
    return torch.where(torch.isnan(x), x, out)


def safe_div(num, denom):
    """Parity: style/model.py:854-860 — nudge near-zero denominators by eps."""
    small = torch.abs(denom) < EPSILON
    denom = torch.where(small, torch.where(denom < 0, denom - EPSILON,
                                           denom + EPSILON), denom)
    return num / denom


def get_mean(tensors, weights=None, mean_type: str = "arithmetic"):
    """Weighted arithmetic/harmonic/geometric/quadratic mean of scalars
    (parity: utils/pytorch.py:74-94). ``weights`` may be tensors (the
    notes/velocity blend uses the notes loss itself as a weight)."""
    n = len(tensors)
    if weights is None:
        weights = [1.0 / n] * n
    if mean_type == "arithmetic":
        out = sum(w * t for t, w in zip(tensors, weights))
    elif mean_type == "harmonic":
        out = 1.0 / get_mean([1.0 / t for t in tensors], weights=weights)
    elif mean_type == "geometric":
        prod = tensors[0]
        for t in tensors[1:]:
            prod = prod * t
        out = prod ** (1.0 / n)
    elif mean_type == "quadratic":
        out = safe_sqrt(get_mean([t * t for t in tensors], weights=weights))
    else:
        raise ValueError(f"Unsupported mean type: {mean_type}")
    return out


# --- channel-tensor losses (dense (B, C, bar, beat, frac, note, feat) inputs)

def get_duration(x):
    return x[..., 0]


def get_velocity(x):
    return x[..., 1]


def get_accidentals(x):
    return x[..., 2:]


def smooth_f_score(pred, target, beta: float = 1.0, group=None):
    """Differentiable F-score on velocity mass (parity: model.py:863-878)."""
    zero = _zero(pred)
    tp, fp, fn = group_sums(group, torch.minimum(pred, target).sum(),
                            torch.maximum(pred - target, zero).sum(),
                            torch.maximum(target - pred, zero).sum())
    precision = safe_div(tp, tp + fp)
    recall = safe_div(tp, tp + fn)
    beta2 = beta * beta
    f = (1 + beta2) * safe_div(precision * recall, beta2 * precision + recall)
    return f, precision, recall


def notes_loss_fn(pred_velocity, target_velocity, beta: float = 1.0,
                  group=None):
    return 1.0 - smooth_f_score(pred_velocity, target_velocity, beta,
                                group)[0]


def velocity_loss_fn(pred, target, mask, group=None):
    x = (target - pred) ** 2 * mask
    total, count = group_sums(group, x.sum(), mask.sum())
    return total / count


def duration_loss_fn(pred, target, mask, group=None):
    capped = torch.minimum(target, target.new_full((), MAX_DURATION))
    x = ((pred - capped) / MAX_DURATION) ** 2 * mask
    total, count = group_sums(group, x.sum(), mask.sum())
    return total / count


def accidentals_loss_fn(pred, target, mask, group=None):
    """Per-note BCE on accidental probabilities (parity: model.py:892-896)."""
    # jnp.clip is minimum(maximum(x, lo), hi): its gradient splits at a tie
    p = torch.minimum(torch.maximum(pred, pred.new_full((), EPSILON)),
                      pred.new_full((), 1.0 - EPSILON))
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    bce = bce * mask[..., None]
    total, count = group_sums(group, bce.sum(), mask.sum())
    return total / (count * 3.0)


def channels_losses(pred, target, pitched: bool = True,
                    pad_mask: Optional[torch.Tensor] = None, group=None):
    """(notes, velocity, duration[, accidentals]) losses for one channel group
    (parity: model.py:909-921). ``pad_mask``: (B, C, bar) validity of each
    (channel, bar) — zeroes padded cells out of every reduction, including the
    model's own predictions there. ``group``: the data axis the batch's
    rows are spread over (None: all rows are here)."""
    # reductions always run in float32 (the global velocity-mass sums over
    # ~10^7 cells need the full mantissa), as in the JAX package
    pred = pred.float()
    target = target.float()
    target_velocity = get_velocity(target)
    pred_velocity = get_velocity(pred)
    if pad_mask is not None:
        m = pad_mask[:, :, :, None, None, None].to(pred.dtype)
        target_velocity = target_velocity * m
        pred_velocity = pred_velocity * m
    mask = (target_velocity > 0).to(pred.dtype)
    notes = notes_loss_fn(pred_velocity, target_velocity, group=group)
    velocity = velocity_loss_fn(pred_velocity, target_velocity, mask, group)
    duration = duration_loss_fn(get_duration(pred), get_duration(target),
                                mask, group)
    if pitched:
        accidentals = accidentals_loss_fn(
            get_accidentals(pred), get_accidentals(target), mask, group)
        return notes, velocity, duration, accidentals
    return notes, velocity, duration


def combine_channel_losses(notes, velocity, duration, accidentals=None,
                           mean_type: str = "quadratic"):
    """"First learn the right notes, then the right velocities"
    (parity: model.py:924-932). The notes loss weights its own mean, and its
    gradient flows through the weights too."""
    notes = get_mean([notes, velocity], [notes, 1.0 - notes],
                     mean_type=mean_type)
    if accidentals is not None:
        return get_mean([duration, accidentals, notes], mean_type=mean_type)
    return get_mean([duration, notes], mean_type=mean_type)


# --- song-info losses

def bce_with_logits(logits, target, group=None):
    """Mean BCE-with-logits (parity: F.binary_cross_entropy_with_logits)."""
    x = torch.maximum(logits, _zero(logits)) - logits * target + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return _mean(x, group)


def cross_entropy_logits(logits, target_index, group=None):
    logz = torch.log(torch.sum(torch.exp(
        logits - logits.amax(dim=-1, keepdim=True)), dim=-1)) \
        + logits.amax(dim=-1)
    picked = torch.gather(logits, -1, target_index[:, None])[:, 0]
    return _mean(logz - picked, group)


def song_info_losses(instruments_pred, instruments_target, mode_pred,
                     mode_target, bpm_pred, bpm_target, group=None):
    """Parity: model.py:899-906 (mean over batch matches torch defaults)."""
    instruments = bce_with_logits(instruments_pred, instruments_target, group)
    mode = cross_entropy_logits(mode_pred, torch.argmax(mode_target, dim=1),
                                group)
    bpm = _mean(((bpm_pred - bpm_target) / BPM_RANGE) ** 2, group)
    return instruments, mode, bpm


class LossDict(NamedTuple):
    """Flat loss record mirroring the reference's nested dict
    (model.py:935-997); ``total`` is the training objective."""

    total: torch.Tensor
    channels_total: torch.Tensor
    pitched_total: torch.Tensor
    pitched_notes: torch.Tensor
    pitched_velocity: torch.Tensor
    pitched_duration: torch.Tensor
    pitched_accidentals: torch.Tensor
    unpitched_total: torch.Tensor
    unpitched_notes: torch.Tensor
    unpitched_velocity: torch.Tensor
    unpitched_duration: torch.Tensor
    song_info_total: torch.Tensor
    instruments: torch.Tensor
    mode: torch.Tensor
    bpm: torch.Tensor

    def as_nested_dict(self) -> dict:
        """The reference's nested structure for logging/CSV parity."""
        unpitched = None
        if not bool(torch.isnan(torch.as_tensor(self.unpitched_total))):
            unpitched = {
                "total": self.unpitched_total,
                "notes_loss": self.unpitched_notes,
                "velocity_loss": self.unpitched_velocity,
                "duration_loss": self.unpitched_duration,
            }
        return {
            "total": self.total,
            "channels_loss": {
                "total": self.channels_total,
                "pitched": {
                    "total": self.pitched_total,
                    "notes_loss": self.pitched_notes,
                    "velocity_loss": self.pitched_velocity,
                    "duration_loss": self.pitched_duration,
                    "accidentals_loss": self.pitched_accidentals,
                },
                "unpitched": unpitched,
            },
            "song_info_loss": {
                "total": self.song_info_total,
                "instruments_loss": self.instruments,
                "mode_loss": self.mode,
                "bpm_loss": self.bpm,
            },
        }


def total_loss(instruments_pred, instruments_target, mode_pred, mode_target,
               bpm_pred, bpm_target, pitched_pred, pitched_target,
               unpitched_pred=None, unpitched_target=None,
               normalize: bool = False, mean_type: str = "quadratic",
               pitched_pad_mask=None, unpitched_pad_mask=None,
               group=None, song_group=None) -> LossDict:
    """The full hierarchical loss (parity: get_total_loss, model.py:935-997).
    ``group``: the process group whose ranks hold the batch's cells; every
    rank gets the global batch's losses. ``song_group``: the group of the
    per-song losses (instruments, mode, bpm) when it is not ``group``:
    ranks that hold other bars of the same songs hold the same per-song
    values, which are summed over the data axis alone.

    The reference's public signature takes (inst, mode, bpm) but its only call
    site passes (inst, bpm, mode) and the inner unpacking swaps them back
    (SURVEY.md §2.1 quirk: the two swaps cancel); this function, like the JAX
    package's, uses the unambiguous order.
    """
    nan = pitched_pred.new_full((), float("nan"), dtype=torch.float32)
    notes, velocity, duration, accidentals = channels_losses(
        pitched_pred, pitched_target, pitched=True, pad_mask=pitched_pad_mask,
        group=group)
    if normalize:
        accidentals = torch.tanh(accidentals)
    pitched_total = combine_channel_losses(notes, velocity, duration,
                                           accidentals, mean_type)

    if unpitched_target is not None:
        u_notes, u_velocity, u_duration = channels_losses(
            unpitched_pred, unpitched_target, pitched=False,
            pad_mask=unpitched_pad_mask, group=group)
        unpitched_total = combine_channel_losses(u_notes, u_velocity,
                                                 u_duration, None, mean_type)
        channels_total = get_mean([pitched_total, unpitched_total],
                                  mean_type=mean_type)
    else:
        u_notes = u_velocity = u_duration = unpitched_total = nan
        channels_total = pitched_total

    instruments, mode, bpm = song_info_losses(
        instruments_pred, instruments_target, mode_pred, mode_target,
        bpm_pred, bpm_target, group if song_group is None else song_group)
    if normalize:
        instruments = torch.tanh(instruments)
        mode = torch.tanh(mode)
    song_info_total = get_mean([instruments, mode, bpm], mean_type=mean_type)

    total = get_mean([channels_total, song_info_total], mean_type=mean_type)
    return LossDict(
        total=total, channels_total=channels_total,
        pitched_total=pitched_total, pitched_notes=notes,
        pitched_velocity=velocity, pitched_duration=duration,
        pitched_accidentals=accidentals, unpitched_total=unpitched_total,
        unpitched_notes=u_notes, unpitched_velocity=u_velocity,
        unpitched_duration=u_duration, song_info_total=song_info_total,
        instruments=instruments, mode=mode, bpm=bpm,
    )


def hard_output(x):
    """Inference thresholding (parity: model.py:818-832): tiny velocities
    zeroed; accidentals -> one-hot at the argmax, gated at 0.1."""
    duration = x[..., :1]
    velocity = x[..., 1:2]
    velocity = velocity * (velocity > 0.01).to(x.dtype)
    if x.shape[-1] > 2:
        acc = x[..., 2:]
        is_max = acc == acc.amax(dim=-1, keepdim=True)
        hard = (is_max & (acc > 0.1)).to(x.dtype)
        return torch.cat([duration, velocity, hard], dim=-1)
    return torch.cat([duration, velocity], dim=-1)
