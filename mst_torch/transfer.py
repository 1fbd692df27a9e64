"""Style transfer: compose one song's melody/rhythm with another's style.

Counterpart of mst_tpu/transfer.py (parity target: style/style_transfer.py),
with the same public entry points and output file layout:

  transfer_style(model_bundle, composition_path, style_paths, output_path)
    -> output_path/<name>/original/<name>.mid
       output_path/<name>/<name> (reconstructed).mid
       output_path/<name>/original/<style>.mid
       output_path/<name>/<name> (<style> style).mid

``transfer_styles`` batches many compositions; ``extract_style`` and
``apply_style(s)`` run the two stages apart; ``transfer_and_evaluate``
scores a transfer's outputs through rendered audio (mst_torch.audio);
``demo_params`` gives untrained weights for structure demos.

The device side of a request runs as static-shape programs, as in
mst_tpu (transfer.py:87-436,928-1137): the songs' note records are
rasterized on the device (K1, ``csrc/raster.cu``) and the latents
extracted (``raster_extract``); for a batch of jobs, song info is
predicted and instruments picked, both appliers run (the pitched one's
note-grid tail is K2, ``csrc/grid_tail.cu``), every cell is packed into one
word, and the nonzero words are compacted at a fixed record capacity into
the ascending (cell, word) records of mst_tpu's ``_compact_song``
(``fused:{capacity}:{Cb}``; on the card at fp32 both steps are K6,
``csrc/pack_compact.cu``, whose records are the composition's bit for
bit). When every song of a request shares one extraction bucket, both
run as one program (``transfer_fused:...``).
Each program returns one buffer in mst_tpu's layout, fetched once; its
header holds the record counts and the live-block counts that the
capacity ladder (``run_fused_jobs``) reads to escalate through
``COMPACT_CAPACITIES``, to pack the records again at the exact
record-pool tier (``POOL_TIERS``; a small ``repack`` program on the
records the run left on the device, where mst_tpu runs its program
again), to fall back to the dense compaction when the block routing table
overflows, and to raise ``OverflowError`` where notes would be lost. The
ladder decides; a launcher runs and fetches its programs:
``_CardLauncher`` on the bundle's one card (the ``fused`` apply on
extracted latents, or the whole request as ``transfer_fused``), and
``_MeshLauncher`` over a mesh. The host decodes the records to ``.mid``.

On the card each program is captured once per shape key as a CUDA graph
and replayed (mst_torch.runtime.programs); ``ModelBundle.capture=False``
runs the same programs eagerly, as the CPU always does. The channel and
bar buckets are kept, so shapes and masks match the JAX programs one to
one. Deliberate difference: the packed words and the fetched buffer are
int64 tensors holding mst_tpu's uint32 values (the host views the buffer
as uint32). ``ModelBundle.call_log``, set to a list, records every
program call, and ``runtime.flops.replay_log_flops`` counts the log's
matmul FLOPs, which a replayed graph cannot show to the counter.

Over a device mesh (``ModelBundle(mesh=parallel.create_device_mesh(...))``,
mst_tpu's ``ModelBundle.mesh``, transfer.py:460-518) one process drives
every card of the mesh's data axis, as JAX's single controller does: the
bundle holds a replica of the model and its own programs on each card,
the extraction batch is padded with all-zero songs to a multiple of the
axis and each shard's songs are rasterized (K1) and extracted on its
card, the job rows are padded by repeating the last job and each shard's
jobs are applied (K2) on its card, and the host fetches each card's rows
in the per-job row layout; every step of the apply that the mesh adds
(the padded job rows, the latent copies, each shard's launch, the fetch
card by card and the join) is ``_MeshLauncher``'s, and the extraction's
shard split is ``_extract_shards``'. A replay or an eager launch on one
card does not wait for another, so the cards work at once. Deliberate
differences: the mesh has a data axis alone (JAX's has a ``seq`` axis
too, over which it computes each row again); a request that mst_tpu runs
as one ``transfer_fused`` program runs as extraction on each card, a copy
of the latents to every card (the gather XLA would insert, outside the
graphs) and the apply on each card; the extracted latents come back on
the mesh's first device; a device may appear in the mesh more than once.

Entry points run on the GPU unless the caller asks for the CPU:
``ModelBundle(device=None)`` resolves to ``cuda`` and raises without it.

Every stage runs under the model config's compute dtype
(mst_torch.ops.precision). The extraction stage may store its activations
at bf16 (``ModelBundle.extract_storage_dtype``; K1 then writes its raster
at bf16); the apply stage always runs at fp32 storage, whatever policy the
process has set, so its packed outputs stay those of the fp32 path
(mst_tpu/transfer.py:285-345,490-494,520-580).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mst_torch import audio, weights
from mst_torch.config import ModelConfig
from mst_torch.data.pipeline import Song, get_input
from mst_torch.data.taxonomy import (
    INCLUDED_INSTRUMENTS, PERCUSSION_ID, category_feature_table,
    category_instrument)
from mst_torch.device import as_device, resolve_device, strict_fp32
from mst_torch.exceptions import MidiFormatError
from mst_torch.io import create_midi, load_midi_from_file, native
from mst_torch.io.midi import bpm2tempo
from mst_torch.models import StyleTransferModel
from mst_torch.ops import compact_kernel, precision
from mst_torch.ops.device_raster import (
    concat_and_pad, encode_notes, segment_rasterize)
from mst_torch.ops.events import SongInfo, read_midi
from mst_torch.ops.rasterize import QNotes, Rasterizer
from mst_torch.runtime.profile import count, span, spanned
from mst_torch.runtime.programs import Programs
from mst_torch.theory.scales import Scale

# Shape buckets (mst_tpu/transfer.py:439-440): channel and bar counts are
# padded up to these, so every tensor and mask has the JAX program's shape.
CHANNEL_BUCKETS = (8, 16, 32)
BAR_BUCKETS = (64, 96, 128, 160, 192, 256, 320, 384, 512, 768, 1024)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


# Compaction capacity tiers (records per job and note family; the
# unpitched family gets a quarter), mst_tpu/transfer.py:87.
COMPACT_CAPACITIES = (16384, 65536, 262144, 1048576)

# Fetched-record pool tiers (mst_tpu/transfer.py:89-98): an apply batch's
# records are packed contiguously across jobs before the fetch
# (``_pack_pool``), so the fetched buffer scales with the observed record
# total, not with B x capacity. Tiers double; a sticky per-bundle hint keeps
# steady requests on the exact tier.
POOL_TIERS = (8192, 16384, 32768, 65536, 131072, 262144, 524288,
              1048576, 2097152, 4194304)


def _pick_pool_tier(n: int) -> int:
    for t in POOL_TIERS:
        if n <= t:
            return t
    return POOL_TIERS[-1]


# the fused buffer's header: [bpm, mode_idx, n_picked, has_unpitched,
# count_p, count_u, live_blocks_p, live_blocks_u]
_HDR = 8

_BLOCK = 128  # compaction block: 128 cells

# ranks per chunk of the big tiers' rank lookup: bounds its (B, chunk, 128)
# transient
_COMPACT_CHUNK = 16384


def _block_capacities(capacity: int) -> Tuple[int, int]:
    """The most nonempty 128-cell blocks the compaction routes at a
    capacity tier (pitched, unpitched), mst_tpu/transfer.py:118-133: the
    routing table sizes only transients inside the program, and the ladder
    escalates when the header's live-block count exceeds it."""
    return max(capacity // 4, 16384), max(capacity // 16, 4096)


def _pool_from_key(rest) -> Optional[Tuple[int, int]]:
    """The optional ``pool=PP,PU`` segment of a fused program's key."""
    for r in rest:
        if r.startswith("pool="):
            pp, pu = r[5:].split(",")
            return int(pp), int(pu)
    return None


def _program_key(kind: str, capacity: int, Cb: int, dense: bool,
                 pool) -> str:
    """``fused:{capacity}:{Cb}[:dense][:pool=PP,PU]`` or the same with
    ``transfer_fused`` (mst_tpu's keys)."""
    key = f"{kind}:{capacity}:{Cb}" + (":dense" if dense else "")
    if pool is not None:
        key += f":pool={pool[0]},{pool[1]}"
    return key


@dataclasses.dataclass
class ModelBundle:
    """The model on its device, its programs and the sticky sizing of its
    requests (mst_tpu's ModelBundle, transfer.py:459-611).
    ``device=None`` resolves to ``cuda``.

    - ``extract_storage_dtype``: the activation storage dtype of the
      extraction stage alone ("bfloat16" or None, which means float32).
    - ``capacity_hint``: the smallest compaction tier the last request's
      counts fit; the next request starts there (it may step back down).
    - ``pool_hint_p``/``pool_hint_u``: the last request's record sums; the
      next request's pool tier is picked from them.
    - ``use_record_pool``: fetch through the packed record pool (False
      keeps the per-job row layout).
    - ``fuse_requests``: run a request whose songs share one extraction
      bucket as one program (False: extraction, then apply).
    - ``capture``: on the card, capture each program as a CUDA graph and
      replay it (mst_torch.runtime.programs); False runs the same programs
      eagerly, for the profile tools, whose traces need the model's
      ``record_function`` scopes.
    - ``call_log``: None, or a list to which every program call appends
      ``(key, inputs, statics, shard)`` (mst_tpu's ``call_log`` of ``(key,
      inputs, statics)``, with the shard whose replica ran the call: 0
      without a mesh); ``runtime.flops.replay_log_flops`` counts it.
    - ``mesh``: None, or a ``parallel.mesh.DeviceMesh`` whose data axis
      shards every batched serving stage (the module's docstring).
      ``device`` is then the mesh's first device (a ``device`` passed must
      name it: ``cuda`` does when card 0 is current); each other card of
      the data axis gets a copy of ``model``, made here, and programs of
      its own. ``use_record_pool`` does not apply: a mesh fetches the
      per-job row layout, as in mst_tpu."""

    model: StyleTransferModel
    device: Optional[object] = None
    extract_storage_dtype: Optional[str] = None
    capacity_hint: int = 0
    pool_hint_p: int = 0
    pool_hint_u: int = 0
    use_record_pool: bool = True
    fuse_requests: bool = True
    capture: bool = True
    call_log: Optional[list] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is None:
            self.device = resolve_device(self.device)
            self.shard_devices = [self.device]
        else:
            self.shard_devices = list(self.mesh.devices)
            if self.device is not None and \
                    as_device(self.device) != self.shard_devices[0]:
                raise ValueError(f"device {self.device} is not the mesh's "
                                 f"first device {self.shard_devices[0]}")
            self.device = self.shard_devices[0]
        if self.extract_storage_dtype is not None:
            precision.as_dtype(self.extract_storage_dtype)
        self.model = self.model.to(self.device).eval()
        table = torch.as_tensor(category_feature_table(), dtype=torch.float32)
        self._feature_table = table.to(self.device)
        self.programs = Programs(self.device)
        # (model, feature table, programs) of each other card of the mesh
        self._replicas = {
            dev: (copy.deepcopy(self.model).to(dev).eval(), table.to(dev),
                  Programs(dev))
            for dev in dict.fromkeys(self.shard_devices) if dev != self.device}

    def data_axis_size(self) -> int:
        """The shards of a batch: the mesh's data axis, or 1."""
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def shard_rows(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A batch-axis tensor, whose rows the data axis divides (pad it
        first), as one row slice per shard (mst_tpu's ``shard_rows``: the
        shards of its sharded array). The slices are views of ``x``: each
        shard's program moves its inputs to its card."""
        n = self.data_axis_size()
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not shard over {n}")
        return list(x.split(x.shape[0] // n))

    def replica(self, shard: int = 0):
        """(model, feature table, programs) on shard ``shard``'s device."""
        dev = self.shard_devices[shard]
        if dev == self.device:
            return self.model, self._feature_table, self.programs
        return self._replicas[dev]

    def policy(self, storage=None):
        """The numeric policy of one stage: the model config's compute dtype
        and ``storage``, where None pins float32 storage and never inherits
        the process's (mst_tpu's ModelBundle._wrap_precision)."""
        return precision.precision(self.model.config.compute_dtype,
                                   storage=storage or "float32")

    def fn(self, key: str, shard: int = 0):
        """The program ``key`` (mst_tpu's ``ModelBundle.fn``) on shard
        ``shard``'s device: a callable ``(*inputs, **statics)`` that runs it
        under its stage's policy through that device's programs (and logs
        the call in ``call_log``). Keys: ``raster_extract`` (the
        extraction, at ``extract_storage_dtype``), ``fused:{capacity}:{Cb}
        [:dense][:pool=PP,PU]`` (the apply of a batch of jobs),
        ``transfer_fused:...`` (both in one program) and
        ``repack:{capacity}:{Cb}:pool=PP,PU`` (a pooled run's records packed
        again at another pool tier, ``_pooled_buffer``)."""
        def program(*inputs, **statics):
            if self.call_log is not None:
                self.call_log.append((key, inputs, statics, shard))
            return self.run(key, inputs, statics, self.capture, shard)
        return program

    def run(self, key: str, inputs, statics: dict, capture: bool,
            shard: int = 0):
        """One call of program ``key`` on shard ``shard``'s replica,
        captured on the card when ``capture``; not logged."""
        model, table, programs = self.replica(shard)
        if key == "raster_extract":
            body = functools.partial(_raster_extract_latents, model)
            storage = self.extract_storage_dtype
        else:
            kind, cap, cb, *rest = key.split(":")
            options = dict(capacity=int(cap), max_channels=int(cb),
                           dense_compaction="dense" in rest,
                           pool=_pool_from_key(rest))
            if kind == "repack":
                body = functools.partial(_pooled_buffer,
                                         pool=options["pool"])
            elif kind == "transfer_fused":
                body = functools.partial(
                    _fused_transfer_full, model, table,
                    extract_storage=self.extract_storage_dtype, **options)
            elif kind == "fused":
                body = functools.partial(_fused_transfer_apply, model, table,
                                         **options)
            else:
                raise KeyError(f"no program {key!r}")
            storage = None
        with self.policy(storage):
            return programs.run(key, body, inputs, statics, capture=capture)

    @classmethod
    def from_npz(cls, path: str = weights.SNAPSHOT_NPZ, device=None,
                 config: ModelConfig = ModelConfig(), **options
                 ) -> "ModelBundle":
        """A bundle with the params of an npz export (default: the committed
        ``snapshots/4900`` export). ``options``: the bundle's other fields
        (``extract_storage_dtype``, ``capture``, ``mesh``, ...)."""
        model = StyleTransferModel(config)
        model.load_state_dict(weights.state_dict_from_flax(
            weights.load_npz(path)))
        return cls(model=model, device=device, **options)

    @classmethod
    def from_checkpoint(cls, directory: str, device=None,
                        config: ModelConfig = ModelConfig(), **options
                        ) -> "ModelBundle":
        """A bundle with the params of the latest checkpoint that the port's
        trainer (``train-model-torch.py``) wrote under ``directory``
        (mst_tpu's load_trained_params). ``options``: as ``from_npz``'s."""
        from mst_torch.runtime.checkpoint import load_trained_params

        state_dict, step = load_trained_params(directory)
        if state_dict is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        model = StyleTransferModel(config)
        model.load_state_dict(state_dict)
        return cls(model=model, device=device, **options)


def sparsify_velocity_bias(state_dict: dict) -> dict:
    """Push the appliers' final-layer velocity bias to -5 so the hard output
    of UNTRAINED params is a realistically sparse roll (a raw init puts
    every velocity above the 0.01 gate) (mst_tpu/transfer.py:614-623).
    In place on the passed dict; returns it."""
    for name in ("pitched_style_applier", "unpitched_style_applier"):
        state_dict[f"{name}.linear.bias"][1] = -5.0
    return state_dict


def demo_params(config: ModelConfig = ModelConfig(), seed: int = 0) -> dict:
    """A fresh init from ``seed`` (``StyleTransferModel.init_parameters``)
    with the velocity bias sparsified, as a state dict for structure demos
    without a trained snapshot (mst_tpu/transfer.py:626-640). The values
    are not JAX's: the two packages draw from different generators."""
    model = StyleTransferModel(config).init_parameters(seed)
    return sparsify_velocity_bias(
        {k: v.clone() for k, v in model.state_dict().items()})


def _pack_word(x, ticks_per_beat):
    """Hard output + lossless packing, ONE int64 word per cell holding the
    uint32 ``dur<<16 | vel<<8 | acc`` of mst_tpu's _pack_word
    (transfer.py:43-84): the velocity byte is the uint8 truncation of
    ``v*127`` after the ``v > 0.01`` gate, the duration the int32 truncation
    of ``d*tpb`` clipped to 0..65535, the accidental the hard flat/natural/
    sharp code (1 when none fires); a cell whose velocity byte is 0 packs to
    0. ``ticks_per_beat`` broadcasts against x[..., 0]."""
    duration = x[..., 0]
    velocity = x[..., 1]
    velocity = velocity * (velocity > 0.01)
    vel = (velocity * 127.0).to(torch.int64)
    dur = (duration * ticks_per_beat).to(torch.int32).clamp(0, 65535)
    if x.shape[-1] > 2:
        acc = x[..., 2:]
        hard = (acc == acc.amax(dim=-1, keepdim=True)) & (acc > 0.1)
        flat, natural, sharp = hard[..., 0], hard[..., 1], hard[..., 2]
        code = torch.where(flat, 0, torch.where(natural, 1,
                                                torch.where(sharp, 2, 1)))
    else:
        code = torch.zeros_like(vel)
    word = (dur.to(torch.int64) << 16) | (vel << 8) | code.to(torch.int64)
    return torch.where(vel > 0, word, torch.zeros_like(word))


def _pick_instruments(logits, n_instruments, max_channels: int):
    """Top-n instrument selection (mst_tpu's _device_pick_instruments,
    transfer.py:136-155; parity style_transfer.py:105-116): a STABLE
    descending sort, and when n_instruments == 1 and the top pick is
    percussion the selection widens to top-2 so one pitched instrument
    survives. ``logits`` (B, 41), ``n_instruments`` (B,). Returns (picked
    category ids (B, max_channels) padded -1, n_picked (B,), has_unpitched
    (B,))."""
    n_cat = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    rank = torch.arange(n_cat, device=logits.device)
    percussion_only = (n_instruments == 1) & (order[:, 0] == PERCUSSION_ID)
    n_top = torch.where(percussion_only, 2, n_instruments)
    in_top = rank[None] < n_top[:, None]
    has_unpitched = (in_top & (order == PERCUSSION_ID)).any(dim=-1)
    keep = in_top & (order != PERCUSSION_ID)
    pos = torch.where(keep, rank[None], n_cat).sort(dim=-1).values
    pos = pos[:, :max_channels]
    picked = torch.where(pos < n_cat,
                         order.gather(1, pos.clamp(max=n_cat - 1)), -1)
    return picked, keep.sum(dim=-1), has_unpitched


def _valid_cells(word, n_channels, n_bars):
    """(B, C, R, 1, ..., 1) bool: the cells of B jobs' packed words (B, C,
    R, ...) that lie below n_channels[b] and n_bars[b]."""
    B, C, R = word.shape[:3]
    dev = word.device
    c_ok = torch.arange(C, device=dev)[None] < n_channels[:, None]
    r_ok = torch.arange(R, device=dev)[None] < n_bars[:, None]
    return (c_ok[:, :, None] & r_ok[:, None, :]).reshape(
        B, C, R, *([1] * (word.dim() - 3)))


def _masked_flat(word, n_channels, n_bars):
    """B jobs' packed words with every cell outside ``_valid_cells``
    zeroed, flat per job: (B, M)."""
    valid = _valid_cells(word, n_channels, n_bars)
    return torch.where(valid, word, 0).reshape(word.shape[0], -1)


def _compact_song(word, n_channels, n_bars, capacity: int, max_blocks: int):
    """Compaction of B jobs' packed words (B, C, R, T, F10, N) at a fixed
    record capacity: mst_tpu's ``_compact_song`` (transfer.py:158-241),
    batched over the jobs. Cells of channel >= n_channels[b] or bar >=
    n_bars[b] are masked; job b's nonzero words come back as records
    ``[cell, word]`` in ascending cell order. Returns (count (B,),
    n_live_blocks (B,), records (B, capacity, 2)), all int64, with
    mst_tpu's values bit for bit:

    - the roll is cut into 128-cell blocks; their inclusive prefix sums
      are one (B*G, 128) @ (128, 128) product, as on the TPU, here in fp16
      on the tensor cores: 0/1 products, and sums up to 128, are exact in
      fp16 whatever the accumulation. (On an NVIDIA H100 80GB HBM3 at
      700 W, a ``cumsum`` along the blocks of 12 jobs' pitched words took
      1.07 ms, the whole compaction with the product 0.71 ms at 16,384
      records: tools/compaction_torch.py, PERF.md.)
    - only the first ``max_blocks`` live (nonempty) blocks are routed:
      ``count`` sums theirs, so it under-reports when the live blocks
      overflow the routing table, and ``n_live_blocks`` counts them all —
      the ladder escalates on either;
    - output rank q finds its block by a ``searchsorted`` over the routed
      blocks' prefix and its cell by a ``searchsorted`` in that block's
      prefix row; ranks >= count are (0, 0);
    - above ``_COMPACT_CHUNK`` ranks the lookup runs in chunks, which bounds
      its (B, chunk, 128) transient of prefix rows.

    Nothing here waits for the device: no ``nonzero``, no shape that
    depends on the data."""
    B = word.shape[0]
    dev = word.device
    words = word.reshape(B, -1)
    M = words.shape[1]
    G = -(-M // _BLOCK)
    mask = ((word != 0) & _valid_cells(word, n_channels, n_bars)).reshape(
        B, M).to(torch.float16)
    if G * _BLOCK != M:
        mask = F.pad(mask, (0, G * _BLOCK - M))
    # a row of 128 0/1 cells times the upper triangle of ones is its
    # inclusive prefix (made on the device: a capture refuses a host copy)
    upper = torch.ones(_BLOCK, _BLOCK, dtype=torch.float16,
                       device=dev).triu()
    within = mask.view(B * G, _BLOCK) @ upper
    counts = within[:, -1].view(B, G).to(torch.int64)  # notes per block
    live = counts > 0
    n_live = live.sum(-1)
    # the routing table: the first max_blocks live blocks, padded with G-1
    k = torch.arange(max_blocks, device=dev)
    routed = k[None] < n_live[:, None]
    live_idx = torch.searchsorted(live.cumsum(-1),
                                  k.expand(B, max_blocks).contiguous(),
                                  right=True)
    live_idx = torch.where(routed, live_idx, G - 1)
    live_counts = torch.where(routed, counts.gather(1, live_idx), 0)
    prefix = live_counts.cumsum(-1)                   # inclusive
    total = prefix[:, -1]
    starts = prefix - live_counts
    row0 = (torch.arange(B, device=dev) * G)[:, None]

    def rank_lookup(q):
        """Consecutive ranks ``q`` -> (B, len(q), 2) records."""
        qb = q.expand(B, q.shape[0]).contiguous()
        j = torch.searchsorted(prefix, qb, right=True).clamp(
            max=max_blocks - 1)
        block = live_idx.gather(1, j)
        rows = within[(block + row0).reshape(-1)]     # (B*len(q), 128)
        # the cell holds the block's (q - start + 1)-th note: the first
        # lane whose inclusive prefix reaches it
        nth = (qb - starts.gather(1, j) + 1).clamp(0, _BLOCK + 1)
        lane = torch.searchsorted(rows, nth.reshape(-1, 1).to(rows.dtype))
        on = qb < total[:, None]
        cell = torch.where(
            on, (block * _BLOCK + lane.view(B, -1)).clamp(max=M - 1), 0)
        payload = torch.where(on, words.gather(1, cell), 0)
        return torch.stack([cell, payload], dim=-1)

    q = torch.arange(capacity, device=dev)
    if capacity <= _COMPACT_CHUNK:
        rec = rank_lookup(q)
    else:
        rec = torch.cat([rank_lookup(c) for c in q.split(_COMPACT_CHUNK)],
                        dim=1)
    return total, n_live, rec


def _compact_song_dense(word, n_channels, n_bars, capacity: int):
    """The escape hatch of the ladder (mst_tpu/transfer.py:244-259), for
    rolls so spread that the live blocks overflow even the top tier's
    routing table while the records fit: a ``cumsum`` of the nonzero mask
    ranks every cell, and a scatter puts the first ``capacity`` nonzero
    cells in order. Returns the true count, 0 live blocks, and records
    bit-equal to mst_tpu's: past the count, ``[0, word of cell 0]``, as
    its ``jnp.nonzero(..., fill_value=0)`` gives. No ``torch.nonzero``: it
    waits for the device, and a capture refuses it."""
    flat = _masked_flat(word, n_channels, n_bars)
    B, M = flat.shape
    dev = flat.device
    nz = flat != 0
    rank = nz.cumsum(-1) - 1
    slot = torch.where(nz & (rank < capacity), rank, capacity)
    cells = torch.arange(M, device=dev).expand(B, M)
    idx = torch.zeros(B, capacity + 1, dtype=torch.int64, device=dev)
    idx = idx.scatter_(1, slot, cells)[:, :capacity]
    count = nz.sum(-1)
    return count, torch.zeros_like(count), torch.stack(
        [idx, flat.gather(1, idx)], dim=-1)


def _pack_pool(rec, counts, pool_cap: int):
    """B jobs' records ((B, cap, 2), job b's first counts[b] live) packed
    contiguously into one (pool_cap, 2) buffer (mst_tpu/transfer.py:
    262-282): job b's records start at sum(counts[:b]), in its order.
    Ranks past the total are 0; a total above ``pool_cap`` is truncated,
    which the host sees from the untruncated header counts."""
    B, cap = rec.shape[:2]
    incl = counts.cumsum(0)
    q = torch.arange(pool_cap, device=rec.device)
    job = torch.searchsorted(incl, q, right=True).clamp(max=B - 1)
    start = incl[job] - counts[job]
    on = q < incl[-1]
    idx = torch.where(on, (q - start).clamp(max=cap - 1), 0)
    return torch.where(on[:, None], rec[job, idx], 0)


def _pooled_buffer(head, rec_p, count_p, rec_u, count_u, *, pool):
    """B jobs' flat pooled buffer ``[B*(8+Cb) headers and picks | PP*2
    pitched pool | PU*2 unpitched pool]`` (``_pack_pool`` of each family)
    from the header and pick rows ``head`` (B, 8 + Cb) and each family's
    per-job records (B, cap, 2) and counts (B,). The pool layout's tail of
    the ``fused`` program and the whole ``repack`` program, so a re-pack at
    a tier is bit-equal to a whole run's buffer at that tier."""
    return torch.cat([head.reshape(-1),
                      _pack_pool(rec_p, count_p, pool[0]).reshape(-1),
                      _pack_pool(rec_u, count_u, pool[1]).reshape(-1)])


def _fused_transfer_apply(model: StyleTransferModel, feature_table, style,
                          melody, rhythm, style_idx, comp_idx,
                          n_instruments, bar_lengths, tpb, *, capacity: int,
                          max_channels: int, dense_compaction: bool = False,
                          pool=None):
    """The apply of B jobs as one program (mst_tpu/transfer.py:351-436):
    job b pairs ``style[style_idx[b]]`` with the composition latents
    ``melody[comp_idx[b]]``, ``rhythm[comp_idx[b]]``; then song-info
    prediction, the instrument pick and feature gather, both appliers (K2),
    packing, and the compaction at ``capacity`` (block-routed: K6 where
    ``compact_kernel.takes_kernel`` says so, else ``_compact_song`` of
    ``_pack_word``; or ``dense_compaction``, which packs with
    ``_pack_word``). ``n_instruments`` and ``bar_lengths`` (B,)
    int64, ``tpb`` (B,) float32 ticks per beat.

    Returns an int64 tensor holding uint32 values in mst_tpu's layout:
    with ``pool=None`` (B, 8 + Cb + capacity*2 + (capacity//4)*2), per job
    ``[header(8) | picked(Cb) | pitched records | unpitched records]``;
    with ``pool=(PP, PU)`` the flat ``[B*(8+Cb) headers and picks | PP*2
    pitched pool | PU*2 unpitched pool]`` (``_pooled_buffer``), and with it
    that buffer's inputs ``(head, rec_p, count_p, rec_u, count_u)``, which
    stay on the device for a re-pack at another pool tier (``repack``
    programs). The header is ``[bpm, mode, n_picked, has_unpitched,
    count_p, count_u, live_blocks_p, live_blocks_u]``; picked is -1 past
    n_picked (0xFFFFFFFF as uint32)."""
    style = style[style_idx]
    melody = melody[comp_idx]
    rhythm = rhythm[comp_idx]
    B = style.shape[0]
    inst_logits, mode_pred, bpm_pred = model.predict_song_info(
        style, rhythm, bar_lengths=bar_lengths)
    picked, n_picked, has_unpitched = _pick_instruments(
        inst_logits, n_instruments, max_channels)
    instf = torch.where((picked >= 0)[..., None],
                        feature_table[picked.clamp(min=0)], 0.0)
    x_p, x_u = model.apply_style(style, melody, rhythm, instf, True)
    tpb_b = tpb.reshape((B,) + (1,) * 5)
    cap_u = capacity // 4
    u_channels = has_unpitched.to(torch.int64)
    if dense_compaction:
        count_p, live_p, rec_p = _compact_song_dense(
            _pack_word(x_p, tpb_b), n_picked, bar_lengths, capacity)
        count_u, live_u, rec_u = _compact_song_dense(
            _pack_word(x_u, tpb_b), u_channels, bar_lengths, cap_u)
    else:
        blocks_p, blocks_u = _block_capacities(capacity)

        def compact(x, n_channels, cap, max_blocks):
            """K6 where it takes the call, else the composition."""
            if compact_kernel.takes_kernel(x):
                return compact_kernel.pack_compact(
                    x, tpb, n_channels, bar_lengths, cap, max_blocks)
            return _compact_song(_pack_word(x, tpb_b), n_channels,
                                 bar_lengths, cap, max_blocks)

        count_p, live_p, rec_p = compact(x_p, n_picked, capacity, blocks_p)
        count_u, live_u, rec_u = compact(x_u, u_channels, cap_u, blocks_u)
    header = torch.stack([
        torch.round(bpm_pred).to(torch.int64),
        torch.argmax(mode_pred, dim=-1), n_picked, u_channels,
        count_p, count_u, live_p, live_u], dim=1)
    head = torch.cat([header, picked], dim=1)
    if pool is None:
        return torch.cat([head, rec_p.reshape(B, -1), rec_u.reshape(B, -1)],
                         dim=1)
    kept = (head, rec_p, count_p, rec_u, count_u)
    return _pooled_buffer(*kept, pool=pool), kept


def _fused_transfer_full(model: StyleTransferModel, feature_table, p_notes,
                         u_notes, mode, bpm, instf, lengths, cmask, umask,
                         style_idx, comp_idx, n_instruments, bar_lengths, tpb,
                         *, B, Cb, Rb, T, capacity: int, max_channels: int,
                         dense_compaction: bool = False,
                         extract_storage=None, pool=None):
    """A whole request as one program (mst_tpu/transfer.py:321-348): the
    rasterization (K1) and latent extraction of the B songs, at the
    ``extract_storage`` storage dtype, then ``_fused_transfer_apply`` of
    every job on those latents, at the caller's fp32 storage."""
    with precision.precision(precision.compute_dtype(),
                             storage=extract_storage or "float32"):
        style, melody, rhythm = _raster_extract_latents(
            model, p_notes, u_notes, mode, bpm, instf, lengths, cmask, umask,
            B=B, Cb=Cb, Rb=Rb, T=T)
    return _fused_transfer_apply(
        model, feature_table, style, melody, rhythm, style_idx, comp_idx,
        n_instruments, bar_lengths, tpb, capacity=capacity,
        max_channels=max_channels, dense_compaction=dense_compaction,
        pool=pool)


# the stages of a request, by tools/profile_transfer.py's names: spans of
# the request's unit (``REQUEST_SPAN``, mst_torch.runtime.profile), which
# ``transfer_styles(..., stage=timer)`` also times; 2a-2c, 5a-5d and 6a are
# split out of 2, 5 and 6 (2b-2c and 5a-5d are the shards' stages: 2b runs
# over a mesh alone; "{}" is the shard)
REQUEST_SPAN = "transfer.request"
STAGE_INGEST = "1 ingest (read_midi+get_input)"
STAGE_EXTRACT_DISPATCH = "2 extract dispatch"
STAGE_NOTE_RECORDS = "2a note-record prep (out of 2)"
STAGE_LATENT_GATHER = "2b latent gather (out of 2)"
STAGE_SHARD_EXTRACT = "2c extract dispatch, shard {} (out of 2)"
STAGE_EXTRACT_BLOCK = "3 extract block"
STAGE_ORIGINALS = "4 originals decode+write"
STAGE_APPLY = "5 apply dispatch+fetch"
STAGE_LATENT_COPY = "5a latent copy (out of 5)"
STAGE_SHARD_APPLY = "5b apply dispatch, shard {} (out of 5)"
STAGE_SHARD_FETCH = "5c fetch, shard {} (out of 5)"
STAGE_FETCH_JOIN = "5d join and convert (out of 5)"
STAGE_STYLED = "6 styled decode+write"
STAGE_PACKED_DECODE = "6a packed-job decode (out of 6)"
REQUEST_STAGES = (STAGE_INGEST, STAGE_EXTRACT_DISPATCH, STAGE_NOTE_RECORDS,
                  STAGE_EXTRACT_BLOCK, STAGE_ORIGINALS, STAGE_APPLY,
                  STAGE_STYLED, STAGE_PACKED_DECODE)
# the stages that leave their device work to a later stage: a timed
# request waits for the cards as each other stage closes
UNSYNCED_STAGES = (STAGE_EXTRACT_DISPATCH, STAGE_NOTE_RECORDS,
                   STAGE_SHARD_EXTRACT, STAGE_SHARD_APPLY, STAGE_SHARD_FETCH,
                   STAGE_FETCH_JOIN)


def ingest_map(fn, paths):
    """Map ingestion over paths: threaded when the host has cores to spare
    (parsing/quantization release the GIL inside numpy and the C++ codec),
    plain iteration on a single-core host."""
    paths = list(paths)
    if (os.cpu_count() or 1) <= 1 or len(paths) <= 1:
        return [fn(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        return list(pool.map(fn, paths))


def get_model_input(path) -> Optional[Tuple[str, Song]]:
    """Parity: style_transfer.py:57-64."""
    mid = load_midi_from_file(path)
    if mid is None:
        return None
    channels, info = read_midi(mid)
    allowed = set([-1, *INCLUDED_INSTRUMENTS])
    channels = [c for c in channels if c["instrument_id"] in allowed]
    song = get_input(channels, info)
    song.path = str(path)
    return str(path), song


@dataclasses.dataclass
class LatentBatch:
    """Latents of B songs sharing one (Cb, Rb, T) bucket, on the bundle's
    device (over a mesh, the real songs' rows gathered from the shards)."""

    style: torch.Tensor    # (B, S)
    melody: torch.Tensor   # (B, Rb, T, 10, 56, melody_size)
    rhythm: torch.Tensor   # (B, Rb, T, 10, rhythm_size)
    n_bars: List[int]      # per-song real bar count


def _extract_shards(bundle: ModelBundle, songs: Sequence[Song], T: int,
                    has_unpitched: bool):
    """The inputs of one extraction batch, by shard (mst_tpu's
    _extract_inputs, transfer.py:731-797): every song's quantized note
    records are offset into one flat row space (song b = channel block
    b*Cb..), so one scatter materializes the whole (B, Cb, Rb, ...) raster
    batch. Over a mesh the batch is padded to a multiple of the data axis
    with all-zero songs of length 1 (transfer.py:741-744,779), and each
    shard's records hold its own songs alone, rebased into its B/n x Cb
    channel blocks (the scheme of ops.device_raster.
    device_rasterize_batch_sharded), so K1 builds each shard's raster on
    its card; Cb and Rb come from the whole batch. Returns (inputs of each
    shard, statics, per-song real bar counts): ``inputs`` are host tensors
    in ``_raster_extract_latents``' order, the program moves them to the
    device; ``statics`` are B (a shard's rows), Cb, Rb and T. Without a
    mesh there is one shard."""
    B_real = len(songs)
    n_shards = bundle.data_axis_size()
    B = -(-B_real // n_shards)          # rows of one shard
    caps = [1000 // s.n_channels for s in songs]
    Cs = [s.pitched_shape[0] for s in songs]
    Rs = [min(s.pitched_shape[1], cap) for s, cap in zip(songs, caps)]
    Cb = _bucket(max(Cs), CHANNEL_BUCKETS)
    Rb = _bucket(max(Rs), BAR_BUCKETS)

    def records(pitched, shard):
        with span(STAGE_NOTE_RECORDS):
            parts = []
            first = shard * B
            n_channels = Cb if pitched else 1
            for b in range(first, min(first + B, B_real)):
                song = songs[b]
                rasterizer = Rasterizer(song.info)
                note_arrays = (song.pitched_notes if pitched
                               else song.unpitched_notes)
                for c, n in enumerate(note_arrays[:n_channels]):
                    q = rasterizer.quantize(n, pitched)
                    parts.append(encode_notes(
                        rasterizer, q, (b - first) * n_channels + c, pitched,
                        B * n_channels, Rb, valid_bars=Rs[b]))
            return concat_and_pad(parts).to("cpu")

    rows = B * n_shards
    instf = np.zeros((rows, Cb, songs[0].instruments_features.shape[-1]),
                     np.float32)
    cmask = np.zeros((rows, Cb), np.float32)
    mode = np.zeros((rows, 2), np.float32)
    bpm = np.full((rows,), 120.0, np.float32)
    for b, song in enumerate(songs):
        instf[b, :Cs[b]] = song.instruments_features
        cmask[b, :Cs[b]] = 1.0
        mode[b] = [0.0, 1.0] if song.info.scale.is_minor else [1.0, 0.0]
        bpm[b] = song.info.bpm
    lengths = torch.tensor(Rs + [1] * (rows - B_real), dtype=torch.int64)
    fields = zip(*(bundle.shard_rows(x) for x in (
        torch.from_numpy(mode), torch.from_numpy(bpm),
        torch.from_numpy(instf), lengths, torch.from_numpy(cmask))))
    shards = [(records(True, shard),
               records(False, shard) if has_unpitched else None,
               *mine,
               # parity: prepare_input passes percussion whenever present,
               # even all-zero (style_transfer.py:70-73)
               torch.ones((B, 1)) if has_unpitched else None)
              for shard, mine in enumerate(fields)]
    return shards, dict(B=B, Cb=Cb, Rb=Rb, T=T), Rs


def _raster_extract_latents(model: StyleTransferModel, p_notes, u_notes,
                            mode, bpm, instf, lengths, cmask, umask, *, B,
                            Cb, Rb, T):
    """On-device rasterization of both note families (K1) + the latent
    extractor for a batch of B songs (mst_tpu's _raster_extract_latents),
    the body of the ``raster_extract`` program. K1 writes the rasters at
    the storage dtype in force. The raster stays NF-fused, (…, 56*5); the
    model splits it."""
    store = precision.storage_dtype()
    flat_p = segment_rasterize(*p_notes, B * Cb * Rb * T * 10, 56, 5, store)
    pitched = flat_p.reshape(B, Cb, Rb, T, 10, 56 * 5)
    unpitched = None
    if u_notes is not None:
        flat_u = segment_rasterize(*u_notes, B * Rb * T * 10, 47, 2, store)
        unpitched = flat_u.reshape(B, 1, Rb, T, 10, 47 * 2)
    return model.extract_style(mode, bpm, pitched, instf, unpitched,
                               bar_lengths=lengths, channel_mask=cmask,
                               uchannel_mask=umask)


def extract_styles(bundle: ModelBundle, songs: Sequence[Song]):
    """Batched latent extraction: songs are grouped by (beats-per-bar,
    percussion presence), and each group is one bucket-padded batch, run
    as one ``raster_extract`` program (over a mesh, one on each shard's
    device). Returns (batches, locators): a list of LatentBatch plus, per
    input song, its (batch_index, row)."""
    group_keys = {}
    group_members = []
    locators = [None] * len(songs)
    for i, song in enumerate(songs):
        key = (song.info.n_beats, song.unpitched_shape is not None)
        if key not in group_keys:
            group_keys[key] = len(group_members)
            group_members.append([])
        group_members[group_keys[key]].append(i)
    batches = []
    for (T, has_unpitched), members in zip(group_keys, group_members):
        shards, statics, Rs = _extract_shards(
            bundle, [songs[i] for i in members], T, has_unpitched)
        outs = []
        for shard, inputs in enumerate(shards):
            with span(STAGE_SHARD_EXTRACT.format(shard)):
                outs.append(bundle.fn("raster_extract", shard)(*inputs,
                                                               **statics))
        if len(outs) == 1:
            style, melody, rhythm = outs[0]
        else:   # the real songs' rows, on the mesh's first device
            with span(STAGE_EXTRACT_BLOCK):
                pass    # a timed request waits here: 2b is the gather alone
            with span(STAGE_LATENT_GATHER):
                style, melody, rhythm = (
                    torch.cat([t.to(bundle.device) for t in parts])[:len(Rs)]
                    for parts in zip(*outs))
        for row, i in enumerate(members):
            locators[i] = (len(batches), row)
        batches.append(LatentBatch(style=style, melody=melody, rhythm=rhythm,
                                   n_bars=Rs))
    return batches, locators


def extract_style(bundle: ModelBundle, song: Song):
    """One song's latents through ``extract_styles`` (mst_tpu/transfer.py:
    683-693; parity style_transfer.py:67-74, max_n_bars = 1000 //
    n_channels). The latents are bucket-padded (batch axis 1); latents at
    valid cells equal an unpadded forward's. Returns (style, melody,
    rhythm, real bar count)."""
    strict_fp32()
    with torch.inference_mode():
        batches, _ = extract_styles(bundle, [song])
    batch = batches[0]
    return batch.style, batch.melody, batch.rhythm, batch.n_bars[0]


def _fits(capacity: int, count_p: int, count_u: int, live_p: int,
          live_u: int) -> bool:
    """Do the record counts and the live-block counts fit a compaction
    tier?"""
    blocks_p, blocks_u = _block_capacities(capacity)
    return (count_p <= capacity and count_u <= capacity // 4
            and live_p <= blocks_p and live_u <= blocks_u)


def _header_table(buf: np.ndarray, B: int, Cb: int, pool) -> np.ndarray:
    """The (B, 8) header rows of a fetched fused buffer."""
    if pool is None:
        return buf[:B, :_HDR]
    return buf[:B * (_HDR + Cb)].reshape(B, _HDR + Cb)[:, :_HDR]


def unpack_job_records(buf: np.ndarray, B: int, Cb: int, capacity: int,
                       pool):
    """A fetched fused buffer (uint32) as B per-job views ``(header (8,),
    picked (Cb,) int32, rec_p (count_p, 2), rec_u (count_u, 2))``, in
    either layout (mst_tpu/transfer.py:944-974)."""
    out = []
    if pool is None:
        base = _HDR + Cb
        for b in range(B):
            row = buf[b]
            hdr = row[:_HDR]
            picked = np.ascontiguousarray(row[_HDR:_HDR + Cb]).view(np.int32)
            cp, cu = int(hdr[4]), int(hdr[5])
            out.append((hdr, picked,
                        row[base:base + capacity * 2].reshape(-1, 2)[:cp],
                        row[base + capacity * 2:].reshape(-1, 2)[:cu]))
        return out
    hdrs = buf[:B * (_HDR + Cb)].reshape(B, _HDR + Cb)
    rec_base = B * (_HDR + Cb)
    rec_p = buf[rec_base:rec_base + pool[0] * 2].reshape(-1, 2)
    rec_u = buf[rec_base + pool[0] * 2:].reshape(-1, 2)
    off_p = off_u = 0
    for b in range(B):
        hdr = hdrs[b, :_HDR]
        picked = np.ascontiguousarray(hdrs[b, _HDR:]).view(np.int32)
        cp, cu = int(hdr[4]), int(hdr[5])
        out.append((hdr, picked, rec_p[off_p:off_p + cp],
                    rec_u[off_u:off_u + cu]))
        off_p += cp
        off_u += cu
    return out


def run_fused_jobs(bundle: ModelBundle, launcher, B: int, Cb: int,
                   host_work=None):
    """Run B jobs' apply program through the capacity ladder until every
    job's output fits (mst_tpu/transfer.py:977-1095), and fetch its buffer
    (the one wait for the device).

    - The ladder starts at the sticky ``capacity_hint`` and breaks to the
      next tier when a job's record or live-block counts do not fit; the
      hint then becomes the smallest tier the counts fit (it may step
      back down).
    - Through the record pool, a total above the pool tier packs the
      records of the run again at the exact tier (the header sums are
      exact): the ``repack`` program, on the run's records, which stay on
      the device (``_pooled_buffer``; its buffer is the one a whole run at
      that tier gives). A total beyond the top pool tier runs the program
      again in the per-job row layout.
    - When the routing table overflows at the top tier while the records
      fit, the dense compaction runs, and its true counts are checked
      again (an overflowed table under-reports them).
    - Counts beyond the top tier raise ``OverflowError``: the compaction
      has already dropped records.

    Each whole run after the first counts ``transfer.redispatch.<reason>``
    in the request's unit (mst_torch.runtime.profile): ``capacity`` (the
    ladder's next tier), ``pool`` (beyond the top pool tier) or ``dense``;
    each re-pack counts ``transfer.repack``, which a request through the
    pool holds even at 0.

    ``launcher`` launches and fetches the program (``_CardLauncher`` on
    one card, ``_MeshLauncher`` over a mesh's data axis):

    - ``pooled``: whether its runs go through the record pool;
    - ``launch(capacity, dense, pool)`` queues a run and returns ``(out,
      kept)``: its device output and, in the pool layout, the records it
      leaves on the device for ``repack(kept, capacity, pool)``, which
      queues the re-pack and returns its output (else None);
    - ``fetch(out)`` waits for an output and returns the B jobs' buffer
      on the host, as uint32.

    ``host_work`` runs once, after the first run is launched and before
    its buffer is fetched. Returns ``(buf, capacity, pool)``;
    ``unpack_job_records(buf, B, Cb, capacity, pool)`` splits ``buf``."""
    if launcher.pooled:
        count("transfer.repack", 0)

    def launch(capacity, dense, pool, redo):
        """A run of the program; ``redo``: why it runs again, or None."""
        if redo is not None:
            count(f"transfer.redispatch.{redo}")
        return launcher.launch(capacity, dense, pool)

    def counts(buf, pool):
        """The header's (count_p, count_u, live_p, live_u, sum_p, sum_u)."""
        hdr = _header_table(buf, B, Cb, pool)
        return (int(hdr[:, 4].max()), int(hdr[:, 5].max()),
                int(hdr[:, 6].max()), int(hdr[:, 7].max()),
                int(hdr[:, 4].sum()), int(hdr[:, 5].sum()))

    def pools_for(sum_p, sum_u):
        if max(sum_p, sum_u) > POOL_TIERS[-1]:
            return None  # beyond the top tier: the per-job rows
        return (_pick_pool_tier(max(sum_p, 1)),
                _pick_pool_tier(max(sum_u, 1)))

    def exact_pool(buf, capacity, dense, pool, kept, sum_p, sum_u):
        """``(buf, pool)`` at a pool tier that holds the sums: as fetched,
        re-packed, or beyond the top tier run again in the per-job rows."""
        if pool is None or (sum_p <= pool[0] and sum_u <= pool[1]):
            return buf, pool
        pool = pools_for(sum_p, sum_u)
        if pool is None:
            return launcher.fetch(launch(capacity, dense, None, "pool")[0]), \
                None
        count("transfer.repack")
        return launcher.fetch(launcher.repack(kept, capacity, pool)), pool

    pool = pools_for(bundle.pool_hint_p or B * 2048,
                     bundle.pool_hint_u or B * 512) \
        if launcher.pooled else None
    ladder = [c for c in COMPACT_CAPACITIES if c >= bundle.capacity_hint] \
        or [COMPACT_CAPACITIES[-1]]
    redo = None
    for capacity in ladder:
        out, kept = launch(capacity, False, pool, redo)
        if host_work is not None:
            host_work()      # overlaps the device work launched above
            host_work = None
        buf = launcher.fetch(out)
        count_p, count_u, live_p, live_u, sum_p, sum_u = counts(buf, pool)
        if not _fits(capacity, count_p, count_u, live_p, live_u):
            redo = "capacity"
            continue             # the next capacity tier
        buf, pool = exact_pool(buf, capacity, False, pool, kept, sum_p,
                               sum_u)
        bundle.capacity_hint = next(
            c for c in COMPACT_CAPACITIES
            if _fits(c, count_p, count_u, live_p, live_u))
        if launcher.pooled:
            bundle.pool_hint_p, bundle.pool_hint_u = sum_p, sum_u
        return buf, capacity, pool
    capacity = COMPACT_CAPACITIES[-1]
    if count_p <= capacity and count_u <= capacity // 4:
        # the records fit but the live-block routing table overflowed: the
        # dense compaction, whose header carries the true counts
        out, kept = launch(capacity, True, pool, "dense")
        buf = launcher.fetch(out)
        count_p, count_u, _, _, sum_p, sum_u = counts(buf, pool)
    if count_p > capacity or count_u > capacity // 4:
        raise OverflowError(
            f"style application produced {count_p} pitched / {count_u} "
            f"unpitched notes, beyond the largest compaction capacity "
            f"{COMPACT_CAPACITIES[-1]}; the device compaction already "
            f"dropped records, so decoding would silently lose notes")
    buf, pool = exact_pool(buf, capacity, True, pool, kept, sum_p, sum_u)
    if launcher.pooled and pool is not None:
        bundle.pool_hint_p, bundle.pool_hint_u = sum_p, sum_u
    return buf, capacity, pool


class _CardLauncher:
    """``run_fused_jobs``' launcher of a program on the bundle's one card:
    ``kind`` ``fused`` (the apply on extracted latents) or
    ``transfer_fused`` (the whole request), on ``inputs`` and then the
    ``job_rows``, with ``statics``. Its runs go through the record pool
    when the bundle uses it."""

    def __init__(self, bundle: ModelBundle, kind: str, inputs, statics,
                 Cb: int, job_rows):
        self.bundle, self.kind, self.Cb = bundle, kind, Cb
        self.inputs, self.statics = (*inputs, *job_rows), statics
        self.pooled = bundle.use_record_pool

    def launch(self, capacity, dense, pool):
        with span(STAGE_SHARD_APPLY.format(0)):
            out = self.bundle.fn(_program_key(
                self.kind, capacity, self.Cb, dense, pool))(
                    *self.inputs, **self.statics)
        return (out, None) if pool is None else out

    def repack(self, kept, capacity, pool):
        with span(STAGE_SHARD_APPLY.format(0)):
            return self.bundle.fn(_program_key("repack", capacity, self.Cb,
                                               False, pool))(*kept)

    def fetch(self, out):
        with span(STAGE_SHARD_FETCH.format(0)):
            out = out.cpu()
        with span(STAGE_FETCH_JOIN):
            return out.numpy().astype(np.uint32)


class _MeshLauncher:
    """``run_fused_jobs``' launcher of the ``fused`` apply over the
    bundle's mesh (mst_tpu's ``transfer.py:1000-1023``): the job rows are
    padded to a multiple of the data axis by repeating the last job, the
    latents are copied whole to each shard's card (once, here), every
    shard's program is launched on its card before any fetch, and the
    shards' buffers, in the per-job row layout (a mesh never fetches
    through the record pool), are fetched card by card and joined in shard
    order without the pad rows."""

    pooled = False

    def __init__(self, bundle: ModelBundle, latents, Cb: int, job_rows):
        self.bundle, self.Cb, self.B = bundle, Cb, len(job_rows[0])
        pad = -self.B % bundle.data_axis_size()
        self.rows = list(zip(*(
            bundle.shard_rows(torch.cat([r, r[-1:].repeat(pad)]))
            for r in job_rows)))
        with span(STAGE_LATENT_COPY):
            self.latents = {dev: tuple(t.to(dev) for t in latents)
                            for dev in dict.fromkeys(bundle.shard_devices)}

    def launch(self, capacity, dense, pool):
        key = _program_key("fused", capacity, self.Cb, dense, pool)
        outs = []
        for shard, rows in enumerate(self.rows):
            with span(STAGE_SHARD_APPLY.format(shard)):
                outs.append(self.bundle.fn(key, shard)(
                    *self.latents[self.bundle.shard_devices[shard]], *rows))
        return outs, None

    def fetch(self, outs):
        host = []
        for shard, out in enumerate(outs):
            with span(STAGE_SHARD_FETCH.format(shard)):
                host.append(out.cpu())
        with span(STAGE_FETCH_JOIN):
            return torch.cat(host)[:self.B].numpy().astype(np.uint32)


def _apply_batch(bundle: ModelBundle, infos, launcher_for, Rb: int, T: int,
                 style_idx, comp_idx, n_instruments_list, save_paths,
                 n_bars_list, host_work=None) -> None:
    """B (style row, composition row) jobs through the capacity ladder
    (``run_fused_jobs``, at fp32 storage) on the launcher that
    ``launcher_for(Cb, job_rows)`` makes, each job's records decoded to
    its ``.mid`` (mst_tpu/transfer.py:1098-1137). ``host_work`` runs once
    the program is launched and before its buffer is fetched."""
    with span(STAGE_APPLY), torch.inference_mode():
        Cb = _bucket(max(max(n_instruments_list), 1), CHANNEL_BUCKETS)
        job_rows = (*(torch.tensor(v, dtype=torch.int64) for v in (
            style_idx, comp_idx, n_instruments_list, n_bars_list)),
            torch.tensor([i.ticks_per_beat for i in infos],
                         dtype=torch.float32))
        launcher = launcher_for(Cb, job_rows)
        buf, capacity, pool = run_fused_jobs(bundle, launcher, len(infos),
                                             Cb, host_work)
        views = unpack_job_records(buf, len(infos), Cb, capacity, pool)
    for info, view, path in zip(infos, views, save_paths):
        with span(STAGE_PACKED_DECODE):
            mid = _packed_job_midi(info, *view, Cb, Rb, T)
        with span(STAGE_STYLED):
            _write_midi(mid, path)


def _latent_launcher(bundle: ModelBundle, latents):
    """``_apply_batch``'s ``launcher_for`` of the ``fused`` apply on
    extracted latents ``(style, melody, rhythm)``: over the bundle's mesh,
    or on its card."""
    if bundle.mesh is not None:
        return functools.partial(_MeshLauncher, bundle, latents)

    def on_card(Cb, job_rows):
        with span(STAGE_LATENT_COPY):
            on = tuple(t.to(bundle.device) for t in latents)
        return _CardLauncher(bundle, "fused", on, {}, Cb, job_rows)
    return on_card


def _free_channels(n: int) -> List[int]:
    """First n non-percussion MIDI channel ids (parity: style_transfer.py:78-80)."""
    return [i for i in range(16) if i != 9][:n]


def save_channels(rasterizer: Rasterizer, pitched_channels, unpitched_channels,
                  instruments: Sequence[int], save_path: str) -> None:
    """Decode dense channel tensors to a .mid file (parity:
    style_transfer.py:77-98 + decode_midi :145-158, create_midi max_delta_time=1).

    ``pitched_channels``: (C, bar, beat, frac, 56, 5) or batched (1, C, ...).
    """
    # float32 throughout: the reference decodes through torch float32 tensors
    # (style_transfer.py:91-97), so float32 duration/velocity truncation is the
    # parity behavior
    pitched = np.asarray(pitched_channels, dtype=np.float32)
    if pitched.ndim == 7:
        pitched = pitched[0]
    unpitched = None
    if unpitched_channels is not None:
        unpitched = np.asarray(unpitched_channels, dtype=np.float32)
        if unpitched.ndim == 7:
            unpitched = unpitched[0]

    # decode_midi always thresholds, including originals
    # (style_transfer.py:147) — fused into the derasterize gather (hard=True)
    instruments_data = []
    channel_ids = _free_channels(pitched.shape[0])
    for idx, instrument_id in zip(range(pitched.shape[0]), instruments):
        messages = rasterizer.messages_from_raster(pitched[idx], pitched=True,
                                                   hard=True)
        instruments_data.append({
            "channel_id": channel_ids[idx],
            "instrument_id": int(instrument_id),
            "messages": messages,
        })
    if unpitched is not None:
        messages = rasterizer.messages_from_raster(unpitched[0],
                                                   pitched=False, hard=True)
        instruments_data.append({
            "channel_id": 9, "instrument_id": -1, "messages": messages,
        })

    _write_midi(create_midi(rasterizer.info.as_create_midi_info(),
                            *instruments_data, max_delta_time=1), save_path)


def save_packed_channels(rasterizer: Rasterizer, packed_p, packed_u,
                         instruments: Sequence[int], save_path: str) -> None:
    """Decode packed output, ``(dur, vel, acc)`` uint arrays of shape
    (C, R, T, F10, N) each (``packed_u`` None or of one channel), to a
    .mid (mst_tpu/transfer.py:870-894)."""
    dur, vel, acc = packed_p
    instruments_data = []
    channel_ids = _free_channels(dur.shape[0])
    for idx, instrument_id in zip(range(dur.shape[0]), instruments):
        q = rasterizer.derasterize_packed(dur[idx], vel[idx], acc[idx],
                                          pitched=True)
        instruments_data.append({
            "channel_id": channel_ids[idx],
            "instrument_id": int(instrument_id),
            "messages": rasterizer.qnotes_to_messages(q, pitched=True),
        })
    if packed_u is not None:
        du, vu, au = packed_u
        q = rasterizer.derasterize_packed(du[0], vu[0], au[0], pitched=False)
        instruments_data.append({
            "channel_id": 9, "instrument_id": -1,
            "messages": rasterizer.qnotes_to_messages(q, pitched=False),
        })
    _write_midi(create_midi(rasterizer.info.as_create_midi_info(),
                            *instruments_data, max_delta_time=1), save_path)


def _write_midi(mid, save_path: str) -> None:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    native.write_midi_file(save_path, mid)


def _packed_job_midi(info: SongInfo, header: np.ndarray, picked_all,
                     rec_p: np.ndarray, rec_u: np.ndarray, Cb: int, Rb: int,
                     T: int):
    """The MIDI object of one job's records (one ``unpack_job_records``
    view), mst_tpu's _decode_packed_job (transfer.py:1140-1192) without the
    write. Sets ``info``'s tempo and scale from the header."""
    info.tempo = bpm2tempo(int(header[0]))
    info.scale = Scale(tonic=info.scale.tonic, is_minor=bool(header[1] == 1))
    rasterizer = Rasterizer(info)
    n_picked = int(header[2])
    has_unpitched = bool(header[3])
    picked = picked_all[:n_picked]
    instruments = [category_instrument(int(i)) for i in picked]

    def unpack(recs, shape, n_channels):
        c, bar, beat, frac, note = np.unravel_index(
            recs[:, 0].astype(np.int64), shape)
        dur = (recs[:, 1] >> 16) & 0xFFFF
        vel = (recs[:, 1] >> 8) & 0xFF
        acc = recs[:, 1] & 0xFF
        out = []
        for ci in range(n_channels):
            sel = c == ci
            out.append(QNotes(
                bar=bar[sel].astype(np.int64),
                beat=beat[sel].astype(np.int64),
                frac_idx=frac[sel].astype(np.int32),
                note_idx=note[sel].astype(np.int32),
                duration=dur[sel].astype(np.int64),
                velocity=vel[sel].astype(np.float64) / 127.0,
                acc=acc[sel].astype(np.int32)))
        return out

    qnotes_p = unpack(rec_p, (Cb, Rb, T, 10, 56), n_picked)
    instruments_data = []
    channel_ids = _free_channels(n_picked)
    for c in range(n_picked):
        instruments_data.append({
            "channel_id": channel_ids[c],
            "instrument_id": int(instruments[c]),
            "messages": rasterizer.qnotes_to_messages(qnotes_p[c], True),
        })
    if has_unpitched:
        qnotes_u = unpack(rec_u, (1, Rb, T, 10, 47), 1)
        instruments_data.append({
            "channel_id": 9, "instrument_id": -1,
            "messages": rasterizer.qnotes_to_messages(qnotes_u[0], False),
        })
    return create_midi(rasterizer.info.as_create_midi_info(),
                       *instruments_data, max_delta_time=1)


def apply_style(bundle: ModelBundle, info: SongInfo, style, melody, rhythm,
                n_instruments: int, save_path: str,
                n_bars: Optional[int] = None) -> None:
    """Predict song info, pick the top instruments, decode and save one job
    (mst_tpu/transfer.py:897-906; parity style_transfer.py:101-131, with
    the predicted-mode scale overwrite and the percussion-only top-2
    escalation). ``n_bars``: the real bar count when the latents are
    bucket-padded (default: all of them)."""
    R = rhythm.shape[1] if n_bars is None else n_bars
    apply_styles(bundle, [info], [style], [melody], [rhythm], [n_instruments],
                 [save_path], [R])


def apply_styles(bundle: ModelBundle, infos: Sequence[SongInfo], styles,
                 melodies, rhythms, n_instruments_list: Sequence[int],
                 save_paths: Sequence[str], n_bars_list: Sequence[int]
                 ) -> None:
    """Batched apply_style (mst_tpu/transfer.py:909-925): B jobs whose
    latents (each with a batch axis of 1, tensors or arrays) share one
    (Rb, T) bucket run as one ``fused`` program (through the capacity
    ladder, ``run_fused_jobs``); job b is written to
    ``save_paths[b]``. Like mst_tpu's, the decode sets each info's tempo
    and scale to the predicted ones."""
    strict_fp32()
    dev = bundle.device

    def batch(parts):
        return torch.cat([torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in parts], dim=0)

    style, melody, rhythm = batch(styles), batch(melodies), batch(rhythms)
    idx = list(range(len(infos)))
    _apply_batch(bundle, list(infos),
                 _latent_launcher(bundle, (style, melody, rhythm)),
                 *rhythm.shape[1:3], idx, idx, list(n_instruments_list),
                 list(save_paths), list(n_bars_list))


def combine_info(style_info: SongInfo, melody_info: SongInfo) -> SongInfo:
    """Melody song's timing + style song's scale/tempo
    (parity: style_transfer.py:134-142 — the combined info has no duration, so
    decode falls back to last-message-time + one bar)."""
    return dataclasses.replace(melody_info, tempo=style_info.tempo,
                               scale=style_info.scale, duration=None)


def transfer_style(bundle: ModelBundle, composition_path, style_paths,
                   output_path) -> List[str]:
    """Parity: style_transfer.py:22-54. Returns the written file paths."""
    return transfer_styles(bundle, [composition_path], style_paths,
                           output_path)


@spanned(REQUEST_SPAN)
def transfer_styles(bundle: ModelBundle, composition_paths, style_paths,
                    output_path, stage=None) -> List[str]:
    """Batched transfer_style over many compositions (same per-song outputs
    and file layout as mst_tpu.transfer.transfer_styles, transfer.py:
    1245-1374).

    When every song shares one extraction bucket (beats per bar,
    percussion presence), ``bundle.fuse_requests`` is set and the bundle
    has no mesh, the whole request is one program, ``transfer_fused``:
    extraction and the apply of every (reconstructed and styled) job.
    Otherwise the songs are extracted in batches grouped by that bucket
    (``raster_extract`` each, on every shard of a mesh) and the jobs of one
    composition group are one ``fused`` apply (on every shard). The
    originals' decode overlaps the first group's programs.

    The request is one unit of spans, ``REQUEST_SPAN`` with its stages
    (``REQUEST_STAGES`` and the shards' stages) inside
    (mst_torch.runtime.profile). ``stage``: a ``runtime.profile.StageTimer``
    that reads those stages, each synchronizing the cards as it closes
    (but ``UNSYNCED_STAGES``; tools/profile_transfer_torch.py, which runs
    with ``fuse_requests=False`` to time extraction and apply apart). The
    originals are then decoded alone, between the extraction and the
    apply, so that no stage hides another; the files are the same."""
    strict_fp32()
    all_paths = list(composition_paths) + list(style_paths)
    if not all_paths:
        return []
    timing = contextlib.nullcontext() if stage is None else stage.reading(
        {name.format(shard) for name in UNSYNCED_STAGES
         for shard in range(bundle.data_axis_size())})
    with timing:
        with span(STAGE_INGEST):
            loaded = list(ingest_map(get_model_input, all_paths))
        bad = [p for p, s in zip(all_paths, loaded) if s is None]
        if bad:
            raise MidiFormatError(
                f"could not load {len(bad)} input file(s): {bad}")
        songs = [s for _, s in loaded]
        comps = songs[:len(composition_paths)]
        style_songs = songs[len(composition_paths):]
        group_keys = {(s.info.n_beats, s.unpitched_shape is not None)
                      for s in songs}
        fuse = (bundle.fuse_requests and bundle.mesh is None
                and len(group_keys) == 1)

        with span(STAGE_EXTRACT_DISPATCH), torch.inference_mode():
            if fuse:
                T, has_unpitched = next(iter(group_keys))
                (ext_inputs,), ext_statics, Rs = _extract_shards(
                    bundle, songs, T, has_unpitched)
                locators = [(0, i) for i in range(len(songs))]
                style_rows = list(range(len(songs)))
                n_bars = [Rs]
            else:
                batches, locators = extract_styles(bundle, songs)
                offset = np.cumsum([0] + [b.style.shape[0] for b in batches])
                style_rows = [int(offset[g]) + row for g, row in locators]
                n_bars = [b.n_bars for b in batches]
                style_mat = torch.cat([b.style for b in batches], dim=0)
        names = song_names(composition_paths)
        style_names = song_names(style_paths)

        def host_work():
            with span(STAGE_ORIGINALS):
                write_originals(comps, style_songs, names, style_names,
                                output_path)

        if stage is not None:
            with span(STAGE_EXTRACT_BLOCK):
                pass                      # the extraction's device work
            host_work()
            host_work = None
        with span(STAGE_APPLY):
            jobs_per_group, written = plan_jobs(
                comps, style_songs, locators, style_rows, n_bars, names,
                style_names, output_path)
        for g, jobs in jobs_per_group.items():
            s_idx, c_idx, infos, n_inst, bars, paths = map(list, zip(*jobs))
            if fuse:
                launcher_for = functools.partial(
                    _CardLauncher, bundle, "transfer_fused", ext_inputs,
                    ext_statics)
                Rb, T = ext_statics["Rb"], ext_statics["T"]
            else:
                batch = batches[g]
                launcher_for = _latent_launcher(
                    bundle, (style_mat, batch.melody, batch.rhythm))
                Rb, T = batch.rhythm.shape[1:3]
            _apply_batch(bundle, infos, launcher_for, Rb, T, s_idx, c_idx,
                         n_inst, paths, bars, host_work)
            host_work = None
        if host_work is not None:  # no apply jobs at all
            host_work()
    return written


def song_names(paths) -> List[str]:
    """Each path's file name without its extension: the output names."""
    return [os.path.splitext(os.path.basename(str(p)))[0] for p in paths]


def write_originals(comps: Sequence[Song], style_songs: Sequence[Song],
                    names, style_names, output_path) -> None:
    """Host-side decode of the ingested songs to ``transfer_styles``'
    original/ files: each composition's, and each style's once per
    composition (decoded once, then copied byte for byte)."""
    style_original_bytes = [None] * len(style_songs)
    for i, comp in enumerate(comps):
        out_dir = os.path.join(str(output_path), names[i])
        original = os.path.join(out_dir, f"original/{names[i]}.mid")
        save_channels(Rasterizer(comp.info), comp.pitched, comp.unpitched,
                      comp.instruments, original)
        for j, style_song in enumerate(style_songs):
            path = os.path.join(out_dir, f"original/{style_names[j]}.mid")
            if style_original_bytes[j] is None:
                save_channels(Rasterizer(style_song.info),
                              style_song.pitched, style_song.unpitched,
                              style_song.instruments, path)
                with open(path, "rb") as fh:
                    style_original_bytes[j] = fh.read()
            else:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(style_original_bytes[j])


def plan_jobs(comps: Sequence[Song], style_songs: Sequence[Song], locators,
              style_rows, n_bars, names, style_names, output_path):
    """``transfer_styles``' apply jobs, grouped by the composition's latent
    batch (which fixes Rb and T): each composition's reconstruction, then
    one job per style. ``locators[i]`` is song i's (batch, row) (the
    compositions first, then the styles), ``style_rows[i]`` its row of the
    style matrix, ``n_bars[g][row]`` the real bar count of a batch's row.
    Returns ``(jobs_per_group, written)``: ``{group: [(style row,
    composition row, info, n_instruments, n_bars, path), ...]}``, and every
    path the request writes, in its return order."""
    style_of = style_rows[len(comps):]
    written = []
    jobs_per_group = {}
    for i, comp in enumerate(comps):
        g, row = locators[i]
        out_dir = os.path.join(str(output_path), names[i])
        jobs = jobs_per_group.setdefault(g, [])
        reconstructed = os.path.join(out_dir,
                                     f"{names[i]} (reconstructed).mid")
        jobs.append((style_rows[i], row, comp.info, len(comp.instruments),
                     n_bars[g][row], reconstructed))
        written += [os.path.join(out_dir, f"original/{names[i]}.mid"),
                    reconstructed]
        for j, style_song in enumerate(style_songs):
            info = combine_info(style_info=style_song.info,
                                melody_info=comp.info)
            path = os.path.join(
                out_dir, f"{names[i]} ({style_names[j]} style).mid")
            jobs.append((style_of[j], row, info, len(style_song.instruments),
                         n_bars[g][row], path))
            written += [os.path.join(out_dir,
                                     f"original/{style_names[j]}.mid"), path]
    return jobs_per_group, written


def transfer_and_evaluate(bundle: ModelBundle, composition_path, style_paths,
                          output_path) -> dict:
    """Transfer, then score through rendered audio (mst_tpu/transfer.py:
    1203-1235): ``transfer_style`` (K1 and K2 on the bundle's device), then
    every written file but the originals is rendered on the host and its
    log-mel similarity to its composition and to its style source is taken
    on the bundle's device. Returns ``{path: {"vs_composition": s,
    "vs_style": s}}`` (``vs_style`` only for styled files); a score is None
    where a file has no notes to render."""
    written = transfer_style(bundle, composition_path, style_paths,
                             output_path)
    comp_data = load_midi_from_file(composition_path)
    style_data = {os.path.splitext(os.path.basename(str(p)))[0]:
                  load_midi_from_file(p) for p in style_paths}

    def score(a, b):
        try:
            return audio.spectral_similarity_midi(a, b, device=bundle.device)
        except MidiFormatError:  # a silent output renders no audio
            return None

    scores = {}
    for path in written:
        if os.sep + "original" + os.sep in path:
            continue
        data = load_midi_from_file(path)
        entry = {"vs_composition": score(comp_data, data)}
        for name, sdata in style_data.items():
            if f"({name} style)" in os.path.basename(path):
                entry["vs_style"] = score(sdata, data)
        scores[path] = entry
    return scores
