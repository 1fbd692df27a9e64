"""The training step: forward + loss + summed-gradient accumulation + Adam
with step decay.

Counterpart of mst_tpu/runtime/train.py (parity target: train-model.py:
89-160):

- Adam(lr=.01) with StepLR's schedule (step_size=200, gamma=.9;
  ``make_lr_schedule``) stepped once per optimizer step
  (train-model.py:89-90,151-154);
- gradient accumulation over ``iter_size`` micro-steps by *summing*
  gradients: each micro-step's ``backward()`` adds into ``.grad``, and every
  ``iter_size``-th micro-step applies Adam and clears them;
- the loss call uses normalize=True (train-model.py:118).

optax updates every parameter at every apply; torch Adam skips a parameter
whose ``.grad`` is None. So every parameter holds a ``.grad`` buffer from
the start (``prepare_state``), zero until a backward adds into it; after
micro-steps with no percussion the unpitched branch's buffers stay zero,
and moments, bias correction and updates match optax's.

The step as a program (mst_tpu's ``jax.jit(step, donate_argnums=(0,))``
and the K-step ``lax.scan``). On the card ``make_train_step`` and
``make_multi_train_step`` run their body as a program of the state's
``Programs`` (mst_torch.runtime.programs, ``stateful``): captured once
per capture key as a CUDA graph and replayed. The key holds the batch's
structure, shapes and dtypes, the precision policy, K and the apply
pattern (which of the call's micro-steps apply Adam, mst_tpu's
``lax.cond``). What makes the body capturable:

- every state tensor is allocated before any capture and updated in
  place: the ``.grad`` buffers (backward adds into them; the apply zeroes
  them, never sets them to None), Adam's moments and step count, created
  up front, and the learning rate, a one-element tensor on the card;
- Adam runs with ``capturable=True`` on the card: its step count lives on
  the device and the bias corrections are taken there in fp32, as optax
  takes them (the CPU refuses ``capturable``; there the float64 bias
  correction of torch's default form stays);
- the schedule's rate of each apply of the call is an input (``rates``),
  copied into the optimizer's rate before that apply, so a K-step call
  may cross a decay boundary (``lr_decay_every``);
- the host's bookkeeping, ``micro_step``, ``opt_step`` and the
  scheduler's count, runs after the body, outside the program.

``capture=False`` runs the same body eagerly (the profile tools and FLOP
counting need it: a replay has no ``record_function`` scope and runs no
Python); on the CPU it always runs eagerly. A capture that fails raises.
The state is mutated in place and also returned, to keep the JAX
package's call shape.

On the card each batch's rasters are built by K1 (``device_batch_from_songs``)
and the pitched applier's note-grid tail runs forward through K2 and
backward through K3 (mst_torch.ops.grid_kernel.GridTail).

Under a process mesh (mst_torch.parallel.mesh) each rank holds its rows
of the global batch and, with a seq axis, its bars of them:
``device_batch_from_songs(mesh=...)`` builds them, K1 running on the
rank. The step's per-cell loss sums run over the whole mesh and its
per-song ones over the data axis (every seq rank holds the same songs),
so every rank computes the global batch's losses; each micro-step's
parameter gradients are summed over the mesh before they are added to the
accumulated ones, as JAX's psum inside the step does. Adam then runs on
the same values on every rank. With a seq axis the forward runs under
``ops.seq_context.sequence_sharding``: the bar-axis recurrences, norms and
final-state reads cross ranks there, the loss masks the bars this rank
holds, and the song-info losses, which every seq rank computes alike,
send their gradient back from seq rank 0 alone (``count_once``).

The step runs under the model config's numeric policy
(``ModelConfig.compute_dtype`` and ``storage_dtype``,
mst_torch.ops.precision): with bf16 storage the rasters are built at bf16
(``raster_dtype``), the grid-scale activations are stored at bf16 and the
tail runs the bf16 forms of K2 and K3. Parameters, gradients, the
accumulated gradient and the Adam state stay fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch.optim.lr_scheduler import LambdaLR

from mst_torch.config import Config
from mst_torch.data.pipeline import Song, get_used_instruments, prepare_input
from mst_torch.models import StyleTransferModel
from mst_torch.ops import precision, seq_context
from mst_torch.ops.losses import LossDict, total_loss
from mst_torch.ops.shapes import split_note_features
from mst_torch.device import strict_fp32
from mst_torch.runtime.profile import spanned
from mst_torch.runtime.programs import Programs

ADAM_BETAS = (0.9, 0.999)   # torch Adam defaults (train-model.py:89), optax's
ADAM_EPS = 1e-8


def reproducible_backends() -> None:
    """The card's settings for training: full fp32 (``strict_fp32``) and
    deterministic cuDNN algorithms. With cuDNN's default, a resumed run on
    the card differed from the uninterrupted one in the last bits of some
    losses in 3 of 4 tries, and in none of 2 with determinism on."""
    strict_fp32()
    torch.backends.cudnn.deterministic = True


class Batch(NamedTuple):
    """A padded, fixed-shape batch of songs."""

    mode: torch.Tensor                 # (B, 2)
    bpm: torch.Tensor                  # (B,)
    pitched: torch.Tensor              # (B, C, R, T, 10, 56*5) NF-fused
    instruments_features: torch.Tensor  # (B, C, 51)
    unpitched: Optional[torch.Tensor]  # (B, Cu, R, T, 10, 47*2) or None
    used_instruments: torch.Tensor     # (B, 41)
    bar_lengths: torch.Tensor          # (B,)
    channel_mask: torch.Tensor         # (B, C)
    uchannel_mask: Optional[torch.Tensor]  # (B, Cu) or None


@dataclasses.dataclass
class TrainState:
    """Model, optimizer, schedule and counters. ``micro_step`` counts
    iterations, ``opt_step`` optimizer applications (scheduler steps); the
    accumulated gradient lives in the parameters' ``.grad``. ``programs``
    holds the step programs captured on this state's tensors (None until
    the first captured step; a restore drops them)."""

    model: StyleTransferModel
    optimizer: torch.optim.Adam
    scheduler: LambdaLR
    micro_step: int = 0
    opt_step: int = 0
    programs: Optional[Programs] = None


def make_lr_schedule(config: Config):
    """``opt_step -> lr``: lr * gamma^(opt_step // step_size) (parity:
    StepLR, train-model.py:90), mst_tpu's schedule and the one
    ``make_optimizer``'s scheduler follows."""
    t = config.train

    def schedule(opt_step):
        return t.learning_rate * (t.lr_decay_gamma **
                                  (opt_step // t.lr_decay_every))
    return schedule


def _capturable(device) -> bool:
    """Adam's form on ``device``: ``capturable`` (step count and rate on
    the device) on the card; torch refuses it on the CPU."""
    return torch.device(device).type == "cuda"


def make_optimizer(model: StyleTransferModel, config: Config):
    """(Adam, scheduler): the scheduler sets the rates of
    ``make_lr_schedule`` and is stepped once per optimizer application, as
    optax's update count is (parity: train-model.py:89-90). On the card
    Adam is ``capturable``; ``prepare_state`` gives it its rate tensor and
    its state."""
    t = config.train
    device = next(model.parameters()).device
    optimizer = torch.optim.Adam(model.parameters(), lr=t.learning_rate,
                                 betas=ADAM_BETAS, eps=ADAM_EPS,
                                 capturable=_capturable(device))
    # the first step of each program runs uncaptured by design
    optimizer._warned_capturable_if_run_uncaptured = True
    scheduler = LambdaLR(optimizer, lambda step: t.lr_decay_gamma ** (
        step // t.lr_decay_every))
    return optimizer, scheduler


def prepare_state(state: TrainState) -> TrainState:
    """Give ``state`` its device's form, with every tensor a captured step
    updates allocated now, before any capture: a zero ``.grad`` buffer for
    each parameter that has none, Adam's moments and step count (the step
    count on the device where Adam is ``capturable``), and there the rate
    as a one-element fp32 tensor (a float on the CPU). Drops the state's
    captured programs, which read the tensors this may replace. Returns
    ``state``."""
    optimizer = state.optimizer
    for group in optimizer.param_groups:
        device = group["params"][0].device
        capturable = _capturable(device)
        group["capturable"] = capturable
        rate = float(group["lr"])
        group["lr"] = (torch.tensor(rate, dtype=torch.float32, device=device)
                       if capturable else rate)
        step_device = device if capturable else "cpu"
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            adam = optimizer.state[p]
            if not adam:
                adam["exp_avg"] = torch.zeros_like(p)
                adam["exp_avg_sq"] = torch.zeros_like(p)
                adam["step"] = torch.zeros((), dtype=torch.float32)
            adam["step"] = adam["step"].to(step_device, torch.float32)
    state.programs = None
    return state


def create_train_state(config: Config, device="cuda",
                       seed: Optional[int] = None,
                       model: Optional[StyleTransferModel] = None
                       ) -> TrainState:
    """A fresh model (``init_parameters`` from ``seed``, default the
    config's) on ``device`` with its optimizer; or ``model`` as given."""
    if model is None:
        model = StyleTransferModel(config.model).init_parameters(
            config.train.seed if seed is None else seed)
    model = model.to(device).train()
    optimizer, scheduler = make_optimizer(model, config)
    return prepare_state(TrainState(model=model, optimizer=optimizer,
                                    scheduler=scheduler))


def _bar_positions(n_bars: int, device):
    """The song bars of the batch's ``n_bars`` raster bars: under a
    sequence-sharding context, this rank's share of the bucket."""
    mesh = seq_context.current_seq_mesh()
    first = 0 if mesh is None else mesh.seq_index * n_bars
    return torch.arange(first, first + n_bars, device=device)


def loss_fn(model: StyleTransferModel, batch: Batch, has_unpitched: bool,
            mean_type: str = "quadratic", group=None,
            song_group=None) -> LossDict:
    """The training objective of one batch (mst_tpu's loss_fn). ``group``:
    the ranks that hold the rest of the batch's cells (the losses are then
    the global batch's); ``song_group``: those that hold the rest of its
    songs, when that differs (the data axis of a bar-sharded mesh)."""
    pitched = split_note_features(batch.pitched, 5)
    unpitched = split_note_features(batch.unpitched, 2)
    (inst_pred, mode_pred, bpm_pred), x_pitched, x_unpitched = model(
        batch.mode, batch.bpm, pitched, batch.instruments_features,
        unpitched if has_unpitched else None,
        bar_lengths=batch.bar_lengths, channel_mask=batch.channel_mask,
        uchannel_mask=batch.uchannel_mask if has_unpitched else None)
    inst_pred, mode_pred, bpm_pred = seq_context.count_once(
        inst_pred, mode_pred, bpm_pred)

    R = pitched.shape[2]
    bar_mask = (_bar_positions(R, pitched.device)[None, :]
                < batch.bar_lengths[:, None]).to(pitched.dtype)
    p_mask = batch.channel_mask[:, :, None] * bar_mask[:, None, :]
    u_mask = None
    if has_unpitched:
        u_mask = batch.uchannel_mask[:, :, None] * bar_mask[:, None, :]

    return total_loss(
        inst_pred, batch.used_instruments, mode_pred, batch.mode,
        bpm_pred, batch.bpm,
        x_pitched, pitched,
        x_unpitched, unpitched if has_unpitched else None,
        normalize=True, mean_type=mean_type,
        pitched_pad_mask=p_mask, unpitched_pad_mask=u_mask, group=group,
        song_group=song_group)


def _apply(optimizer: torch.optim.Adam, rate=None) -> None:
    """Adam with the summed gradients, then zero them in place. ``rate``:
    this apply's rate, copied into the optimizer's rate tensor on the card
    (a one-element tensor), set as a float on the CPU; None keeps the rate
    the scheduler left."""
    if rate is not None:
        for group in optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].copy_(rate)
            else:
                group["lr"] = rate
    optimizer.step()
    optimizer.zero_grad(set_to_none=False)


def _advance(state: TrainState, micro_steps: int, applies: int) -> None:
    """The host's bookkeeping of ``micro_steps`` micro-steps, ``applies``
    of which applied Adam."""
    state.micro_step += micro_steps
    for _ in range(applies):
        state.scheduler.step()
        state.opt_step += 1


def apply_updates(state: TrainState) -> None:
    """One optimizer application with the summed gradients at the rate the
    scheduler set, then clear them in place. A parameter without a
    gradient gets a zero one first, so that Adam updates it as optax
    does."""
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _apply(state.optimizer)
    _advance(state, 0, 1)


def _backward_summed(model: StyleTransferModel, total, group) -> None:
    """``total.backward()`` with this micro-step's parameter gradients
    summed over ``group`` (one all-reduce of them all) before they are
    added to the accumulated ones, so the accumulation stays the same on
    every rank. Every rank reaches the same parameters: the model's path
    depends only on the global batch."""
    params = list(model.parameters())
    held = [p.grad for p in params]
    for p in params:
        p.grad = None
    total.backward()
    fresh = [p for p in params if p.grad is not None]
    if fresh:
        flat = torch.cat([p.grad.reshape(-1) for p in fresh])
        dist.all_reduce(flat, group=group)
        for p, g in zip(fresh, flat.split([p.numel() for p in fresh])):
            p.grad = g.view_as(p)
    for p, acc in zip(params, held):
        if acc is not None:
            p.grad = acc if p.grad is None else acc.add_(p.grad)


def _make_body(config: Config, has_unpitched: bool, k: int, mesh=None,
               b_major: bool = False):
    """The body of a K-micro-step call, shared by make_train_step (K = 1)
    and make_multi_train_step: ``body(state, kbatch, rates, pattern=...)``
    runs K micro-steps on the K batches of ``kbatch`` (``b_major``: laid
    out ``b*K + k``, else ``k*B + b``), applies Adam after micro-step
    ``i`` where ``pattern[i]``, at the next rate of ``rates``, and returns
    the (K, n_losses) losses. It touches no host counter."""
    group = None if mesh is None else mesh.group
    song_group = None if mesh is None else mesh.data_group
    compute, storage = config.model.compute_dtype, config.model.storage_dtype
    objective = functools.partial(loss_fn, has_unpitched=has_unpitched,
                                  group=group, song_group=song_group)

    @contextlib.contextmanager
    def forward_context():
        # the config's numeric policy, for the forward and (through the
        # dtypes it leaves on the saved tensors) the backward, and the bar
        # axis over the mesh's seq ranks
        with precision.precision(compute, storage=storage), \
                seq_context.sequence_sharding(mesh):
            yield

    def micro_step(model: StyleTransferModel, batch: Batch):
        with forward_context():
            batch = batch._replace(
                pitched=precision.cast_storage(batch.pitched),
                unpitched=(None if batch.unpitched is None else
                           precision.cast_storage(batch.unpitched)))
            if config.train.remat:
                # recompute the forward during backward instead of saving
                # activations. The recompute enters the forward's contexts
                # itself: the CUDA autograd engine runs it on its own
                # device thread, which does not see this thread's context
                # variables. Every rank recomputes the same graph in the
                # same order, so the collectives of the recompute match.
                # The model draws no random numbers, so no RNG state is
                # saved (reading the card's would refuse a capture).
                losses = torch.utils.checkpoint.checkpoint(
                    objective, model, batch, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        forward_context()))
            else:
                losses = objective(model, batch)
            if group is None:
                losses.total.backward()
            else:
                _backward_summed(model, losses.total, group)
        # one stacked loss vector -> one host fetch for all metrics
        return torch.stack([v.detach().float() for v in losses])

    def split(x, i):
        if x is None:
            return None
        if b_major:
            return x.reshape((x.shape[0] // k, k) + tuple(x.shape[1:]))[:, i]
        return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]

    def body(state: TrainState, kbatch, rates, *, pattern):
        rows, applied = [], 0
        for i, apply in enumerate(pattern):
            rows.append(micro_step(state.model,
                                   Batch(*(split(f, i) for f in kbatch))))
            if apply:
                _apply(state.optimizer, rates[applied])
                applied += 1
        return torch.stack(rows)

    return body


def _make_program(config: Config, has_unpitched: bool, k: int, mesh,
                  capture: bool, b_major: bool):
    """``run(state, kbatch) -> (state, (K, n_losses) losses)``: the body of
    ``_make_body`` as a program of ``state.programs`` on the card (module
    docstring), eagerly elsewhere or without ``capture``, then the host's
    bookkeeping. Each call is the span ``train.step``
    (mst_torch.runtime.profile): its host time, the replay queued."""
    if capture and mesh is not None:
        raise ValueError(
            "capture over a process mesh is not ported: gloo, which ranks "
            "that share a card use, cannot be recorded in a CUDA graph, "
            "and the capture of NCCL collectives is not ported; pass "
            "capture=False")
    body = _make_body(config, has_unpitched, k, mesh, b_major)
    iter_size = config.train.iter_size
    schedule = make_lr_schedule(config)
    compute, storage = config.model.compute_dtype, config.model.storage_dtype
    key = (f"train_step:k={k}:unpitched={int(has_unpitched)}"
           f":remat={int(config.train.remat)}")

    @spanned("train.step")
    def run(state: TrainState, kbatch: Batch):
        pattern = tuple((state.micro_step + i + 1) % iter_size == 0
                        for i in range(k))
        rates = [schedule(state.opt_step + a) for a in range(sum(pattern))]
        lr = state.optimizer.param_groups[0]["lr"]
        if isinstance(lr, torch.Tensor):
            # the card's form: the rates as one small fp32 input
            rates = (torch.tensor(rates, dtype=torch.float32) if rates
                     else None)
        on_card = isinstance(lr, torch.Tensor) and lr.device.type == "cuda"
        if capture and on_card:
            if state.programs is None:
                state.programs = Programs(lr.device)
            # the policy is part of the capture key
            with precision.precision(compute, storage=storage):
                losses = state.programs.run(
                    key, functools.partial(body, state),
                    (tuple(kbatch), rates), {"pattern": pattern},
                    capture=True, stateful=True)
        else:
            if on_card and rates is not None:
                rates = rates.pin_memory().to(lr.device, non_blocking=True)
            losses = body(state, kbatch, rates, pattern=pattern)
        _advance(state, k, sum(pattern))
        return state, losses

    return run


def make_train_step(config: Config, has_unpitched: bool, mesh=None,
                    capture: bool = True):
    """One micro-step: grad, accumulate (sum), apply Adam every
    ``iter_size`` micro-steps with the decayed learning rate. Returns
    ``(state, losses)`` with the losses as one device vector in
    ``LossDict`` order (``LossDict(*vec.tolist())`` reads it), so the caller
    decides when to wait for the device: the CLI fetches each step's vector
    one iteration later, while the next step runs. With ``mesh`` the batch
    holds this rank's rows of the global batch (module docstring).

    ``capture``: on the card, run the step as a program captured once per
    capture key and replayed (module docstring); False runs it eagerly.
    With ``mesh``, capture raises ``ValueError``: pass False."""
    run = _make_program(config, has_unpitched, 1, mesh, capture, False)

    def step(state: TrainState, batch: Batch):
        state, losses = run(state, batch)
        return state, losses[0]

    return step


def make_multi_train_step(config: Config, has_unpitched: bool, k: int,
                          mesh=None, capture: bool = True,
                          b_major: Optional[bool] = None):
    """K micro-steps per call: the input is a :class:`Batch` whose leaves
    carry a leading ``K*B`` axis laid out ``k*B + b`` (one rasterize launch
    per note family for the whole stack, ``device_batch_from_songs`` over
    K*B songs). Returns ``(state, (K, n_losses) loss matrix)``. Semantics
    are K sequential :func:`make_train_step` calls; on the card the K
    micro-steps are one captured program (mst_tpu's scan), ``capture`` as
    make_train_step's.

    ``b_major`` (default: whether there is a ``mesh``): the stack is laid
    out ``b*K + k`` (mst_tpu's ``b_major``): a data rank's rows of it are
    then whole ``b`` blocks, its own rows of every one of the K
    batches."""
    return _make_program(config, has_unpitched, k, mesh, capture,
                         mesh is not None if b_major is None else b_major)


def window_sort(stream, window: int, signature):
    """Reorder ``(cursor, item)`` pairs inside blocks of ``window`` items so
    same-``signature`` items become consecutive (stable within a block) —
    the shape-bucket analogue of NLP length-bucketing, so that
    :func:`group_stacks` forms mostly full K-step stacks.

    Each block is a permutation of ``window`` consecutive stream items, so
    every epoch still visits every song. Resume is conservative: items
    before a block's last carry the cursor that replays the block from its
    first attempt (a mid-block resume re-trains at most ``window - 1`` songs,
    never skips one); the block's final item carries the true end-of-block
    cursor."""
    stream = iter(stream)
    while True:
        block = list(itertools.islice(stream, window))
        if not block:
            return
        # stable sort by signature: items keep stream order within a bucket
        order = sorted(range(len(block)),
                       key=lambda i: (repr(signature(block[i][1])), i))
        replay_block = block[0][0] - 1  # cursor-1 = the attempt index that
        end_cursor = block[-1][0]       # yielded the block's first item
        for n, i in enumerate(order):
            cursor = end_cursor if n == len(order) - 1 else replay_block
            yield cursor, block[i][1]


def group_stacks(stream, k: int, signature, limit: Optional[int] = None):
    """Group consecutive same-signature items from ``(cursor, item)`` pairs
    into stacks of exactly ``k`` for the multi-step path.

    Yields ``(cursor, [items])`` with 1 <= len <= k: a full stack when k
    consecutive items share ``signature(item)``, else the buffered items are
    flushed as singletons. Consecutive-only grouping keeps the exact song
    order, so resume cursors and loss curves stay comparable with the
    per-step path. ``limit``: total item budget (the run's remaining
    iterations) — once fewer than k remain, items flush as singletons so a
    run of exactly ``n_iterations`` never overshoots."""
    buf = []
    buf_sig = None
    emitted = 0

    def room():
        return limit is None or emitted + k <= limit

    for cursor, item in stream:
        sig = signature(item)
        if buf and (sig != buf_sig or not room()):
            for c, it in buf:
                yield c, [it]
                emitted += 1
            buf = []
        if room():
            buf.append((cursor, item))
            buf_sig = sig
            if len(buf) == k:
                yield buf[-1][0], [it for _, it in buf]
                emitted += k
                buf = []
        else:
            yield cursor, [item]
            emitted += 1
    for c, it in buf:
        yield c, [it]
        emitted += 1


def _tensor(x, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)


def batch_from_song(song: Song, max_n_bars: Optional[int] = None,
                    drop_empty_unpitched: bool = True,
                    device="cuda") -> Optional[Batch]:
    """One song as a batch of one at its exact shape (the reference's
    training unit, train-model.py:98-111), from the host raster. Returns
    None for silent songs (parity :105-106)."""
    mode, bpm, pitched, instf, unpitched = prepare_input(song, max_n_bars)
    if pitched.sum() == 0:
        return None
    if unpitched is not None and drop_empty_unpitched and unpitched.sum() == 0:
        unpitched = None
    used = get_used_instruments(instf, unpitched is not None)
    B, C, R = pitched.shape[:3]
    return Batch(
        mode=_tensor(mode, device), bpm=_tensor(bpm, device),
        pitched=_tensor(pitched, device),
        instruments_features=_tensor(instf, device),
        unpitched=None if unpitched is None else _tensor(unpitched, device),
        used_instruments=_tensor(used, device),
        bar_lengths=torch.full((B,), R, dtype=torch.int64, device=device),
        channel_mask=torch.ones((B, C), dtype=torch.float32, device=device),
        uchannel_mask=(None if unpitched is None else torch.ones(
            (B, unpitched.shape[1]), dtype=torch.float32, device=device)),
    )


def bucket_shape(n: int, buckets) -> int:
    """Smallest bucket >= n (falls back to n itself beyond the largest)."""
    for b in buckets:
        if n <= b:
            return b
    return n


def clamp_bar_bucket(Rb: int, B: int, Cb: int, T: int, budget: int,
                     bar_buckets) -> int:
    """Largest bar bucket with B*Cb*Rb*T within the cell budget
    (TrainConfig.batch_cell_budget); floors to a bucket so shapes stay
    bucketed. Returns Rb unchanged when it already fits."""
    allowed = budget // max(B * Cb * T, 1)
    if Rb <= allowed:
        return Rb
    fitting = [b for b in bar_buckets if b <= allowed]
    return fitting[-1] if fitting else max(allowed, 1)


def _song_labels(songs, channel_counts, max_channels, max_uchannels, has_u):
    """Host arrays of a batch: instrument features, masks, mode, bpm and
    used instruments (shared by device_batch_from_songs and pad_batch)."""
    B = len(songs)
    instf = np.zeros((B, max_channels, 51), np.float32)
    cmask = np.zeros((B, max_channels), np.float32)
    umask = np.zeros((B, max_uchannels), np.float32)
    mode = np.zeros((B, 2), np.float32)
    bpm = np.zeros((B,), np.float32)
    used = np.zeros((B, 41), np.float32)
    for i, song in enumerate(songs):
        C = channel_counts[i]
        instf[i, :C] = song.instruments_features[:C]
        cmask[i, :C] = 1.0
        mode[i] = [0.0, 1.0] if song.info.scale.is_minor else [1.0, 0.0]
        bpm[i] = song.info.bpm
        used[i] = get_used_instruments(
            song.instruments_features[None, :C], has_u[i])[0]
    return instf, cmask, umask, mode, bpm, used


def device_batch_from_song(song: Song, max_channels: int, max_bars: int,
                           bar_cap: Optional[int] = None, device="cuda",
                           raster_dtype="float32") -> Optional[Batch]:
    """Bucket-padded batch of one whose rasters are built on the device by
    K1 from the song's note records. None for a silent song."""
    if song.pitched_empty:
        return None
    return device_batch_from_songs([song], max_channels, max_bars,
                                   bar_cap=bar_cap, device=device,
                                   raster_dtype=raster_dtype)


@spanned("data.batch")
def device_batch_from_songs(songs, max_channels: int, max_bars: int,
                            bar_cap=None, max_uchannels: int = 1,
                            device="cuda", raster_dtype="float32",
                            mesh=None) -> Batch:
    """Collate N songs into one fixed-shape Batch whose rasters are built on
    the device: one K1 launch per note family for the whole batch, so only
    the note records cross to the device. Masks and labels equal
    pad_batch's; the songs must share beats-per-bar. The rasters stay
    NF-fused (…, N*F); ``loss_fn`` splits them.

    ``raster_dtype``: K1 writes the rasters at this dtype (pass the
    config's storage_dtype: a bf16-storage step then never holds the fp32
    raster, and its cast_storage of the batch is a no-op).

    ``mesh``: with more than one rank, ``songs`` is the global batch and
    the result is this rank's share of it: its B/n rows (n, the data
    axis, must divide B) and, of the rasters, its ``max_bars``/m bars (m,
    the seq axis, must divide the bucket; ``Mesh.seq_bars``). K1
    rasterizes this rank's songs and bars alone
    (``device_rasterize_batch_sharded``); the per-song fields and the bar
    lengths stay whole. The unpitched raster and mask exist when any song
    of the global batch has percussion, so every rank runs the same model
    path.

    The build is the span ``data.batch`` (mst_torch.runtime.profile): on
    the trainer's prefetch thread, a unit of that thread."""
    from mst_torch.ops.device_raster import (
        device_rasterize_batch, device_rasterize_batch_sharded)
    from mst_torch.ops.rasterize import Rasterizer

    B = len(songs)
    bar_caps = ([bar_cap] * B if bar_cap is None or isinstance(bar_cap, int)
                else list(bar_cap))
    rasterizers = [Rasterizer(s.info) for s in songs]
    valid_bars = []
    channel_counts = []
    for i, song in enumerate(songs):
        R = min(song.n_bars, max_bars)
        if bar_caps[i] is not None:
            R = min(R, bar_caps[i])
        valid_bars.append(R)
        channel_counts.append(min(song.n_channels, max_channels))

    out_dtype = precision.as_dtype(raster_dtype)
    sharded = mesh is not None and mesh.shape["data"] * mesh.shape["seq"] > 1
    mine = mesh.data_rows(B) if sharded else slice(None)

    def build(note_arrays, pitched, n_ch):
        args = (rasterizers, note_arrays, pitched, n_ch, max_bars,
                valid_bars)
        kwargs = dict(fuse_nf=True, device=device, out_dtype=out_dtype)
        if sharded:
            return device_rasterize_batch_sharded(mesh, *args, **kwargs)
        return device_rasterize_batch(*args, **kwargs)

    pitched = build([s.pitched_notes[:c] for s, c in
                     zip(songs, channel_counts)], True, max_channels)
    has_u = [s.has_unpitched for s in songs]
    any_u = any(has_u)
    unpitched = None
    if any_u:
        unpitched = build([(s.unpitched_notes[:max_uchannels] if h else [])
                           for s, h in zip(songs, has_u)], False,
                          max_uchannels)

    songs, has_u = songs[mine], has_u[mine]
    instf, cmask, umask, mode, bpm, used = _song_labels(
        songs, channel_counts[mine], max_channels, max_uchannels, has_u)
    for i, song in enumerate(songs):
        if has_u[i]:
            umask[i, :min(len(song.unpitched_notes), max_uchannels)] = 1.0
    return Batch(
        mode=_tensor(mode, device), bpm=_tensor(bpm, device),
        pitched=pitched, instruments_features=_tensor(instf, device),
        unpitched=unpitched, used_instruments=_tensor(used, device),
        bar_lengths=_tensor(np.asarray(valid_bars[mine]), device,
                            torch.int64),
        channel_mask=_tensor(cmask, device),
        uchannel_mask=_tensor(umask, device) if any_u else None,
    )


def pad_batch(songs, max_channels: int, max_bars: int,
              max_uchannels: int = 1, bar_cap=None, device="cuda") -> Batch:
    """Collate songs into one fixed-shape Batch with masks, from the host
    rasters (the ``--exact-shapes`` batched path).

    ``bar_cap``: per-song bar truncation (the reference's
    max_total_bars // n_channels rule) applied before padding to
    ``max_bars``; an int applies to all songs, a sequence gives per-song
    caps. The rasters are NF-fused, as device_batch_from_songs makes them.
    """
    B = len(songs)
    T = songs[0].beats_per_bar  # metadata — must not force a lazy raster
    bar_caps = ([bar_cap] * B if bar_cap is None or isinstance(bar_cap, int)
                else list(bar_cap))
    pitched = np.zeros((B, max_channels, max_bars, T, 10, 56, 5), np.float32)
    unpitched = np.zeros((B, max_uchannels, max_bars, T, 10, 47, 2),
                         np.float32)
    lengths = np.zeros((B,), np.int64)
    channel_counts = []
    for i, song in enumerate(songs):
        C = min(song.pitched.shape[0], max_channels)
        R = min(song.pitched.shape[1], max_bars)
        if bar_caps[i] is not None:
            R = min(R, bar_caps[i])
        pitched[i, :C, :R] = song.pitched[:C, :R]
        lengths[i] = R
        channel_counts.append(C)
    # has_unpitched is the precomputed "raster exists and sums > 0" flag;
    # testing song.unpitched would force a lazy rasterization per song
    has_u = [s.has_unpitched for s in songs]
    instf, cmask, umask, mode, bpm, used = _song_labels(
        songs, channel_counts, max_channels, max_uchannels, has_u)
    for i, song in enumerate(songs):
        if has_u[i]:
            Cu = min(song.unpitched.shape[0], max_uchannels)
            R = lengths[i]
            unpitched[i, :Cu, :R] = song.unpitched[:Cu, :R]
            umask[i, :Cu] = 1.0
    any_u = any(has_u)
    return Batch(
        mode=_tensor(mode, device), bpm=_tensor(bpm, device),
        pitched=_tensor(pitched.reshape(pitched.shape[:-2] + (-1,)), device),
        instruments_features=_tensor(instf, device),
        unpitched=(_tensor(unpitched.reshape(unpitched.shape[:-2] + (-1,)),
                           device) if any_u else None),
        used_instruments=_tensor(used, device),
        bar_lengths=_tensor(lengths, device),
        channel_mask=_tensor(cmask, device),
        uchannel_mask=_tensor(umask, device) if any_u else None,
    )
