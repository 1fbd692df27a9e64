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

The device side of a request: the songs' note records are rasterized on
the device (K1, ``csrc/raster.cu``), the latents extracted, song info
predicted and instruments picked, both appliers run (the pitched one's
note-grid tail is K2, ``csrc/grid_tail.cu``), every cell is packed into one
word, and the nonzero words are compacted with an ordered ``torch.nonzero``
into the same ascending (cell, word) records as mst_tpu's ``_compact_song``.
The host decodes the records to ``.mid``.

PyTorch runs eagerly, so the JAX package's static-shape machinery has no
counterpart here: no compaction capacity tiers or record pools, no escape
hatch, no fusing of extraction and apply into one program. The channel and
bar buckets are kept, so shapes and masks match the JAX program one to one.

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

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mst_torch import audio, weights
from mst_torch.config import ModelConfig
from mst_torch.data.pipeline import Song, get_input
from mst_torch.data.taxonomy import (
    INCLUDED_INSTRUMENTS, PERCUSSION_ID, category_feature_table,
    category_instrument)
from mst_torch.device import resolve_device, strict_fp32
from mst_torch.exceptions import MidiFormatError
from mst_torch.io import create_midi, load_midi_from_file, native
from mst_torch.io.midi import bpm2tempo
from mst_torch.models import StyleTransferModel
from mst_torch.ops import precision
from mst_torch.ops.device_raster import (
    concat_and_pad, encode_notes, segment_rasterize)
from mst_torch.ops.events import SongInfo, read_midi
from mst_torch.ops.rasterize import QNotes, Rasterizer
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


@dataclasses.dataclass
class ModelBundle:
    """The model on its device. ``device=None`` resolves to ``cuda``.
    ``extract_storage_dtype``: the activation storage dtype of the
    extraction stage alone ("bfloat16" or None, which means float32)."""

    model: StyleTransferModel
    device: Optional[object] = None
    extract_storage_dtype: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.extract_storage_dtype is not None:
            precision.as_dtype(self.extract_storage_dtype)
        self.model = self.model.to(self.device).eval()
        self._feature_table = torch.as_tensor(
            category_feature_table(), dtype=torch.float32).to(self.device)

    def policy(self, storage=None):
        """The numeric policy of one stage: the model config's compute dtype
        and ``storage``, where None pins float32 storage and never inherits
        the process's (mst_tpu's ModelBundle._wrap_precision)."""
        return precision.precision(self.model.config.compute_dtype,
                                   storage=storage or "float32")

    @classmethod
    def from_npz(cls, path: str = weights.SNAPSHOT_NPZ, device=None,
                 config: ModelConfig = ModelConfig(),
                 extract_storage_dtype: Optional[str] = None
                 ) -> "ModelBundle":
        """A bundle with the params of an npz export (default: the committed
        ``snapshots/4900`` export)."""
        device = resolve_device(device)
        model = StyleTransferModel(config)
        model.load_state_dict(weights.state_dict_from_flax(
            weights.load_npz(path)))
        return cls(model=model, device=device,
                   extract_storage_dtype=extract_storage_dtype)

    @classmethod
    def from_checkpoint(cls, directory: str, device=None,
                        config: ModelConfig = ModelConfig(),
                        extract_storage_dtype: Optional[str] = None
                        ) -> "ModelBundle":
        """A bundle with the params of the latest checkpoint that the port's
        trainer (``train-model-torch.py``) wrote under ``directory``
        (mst_tpu's load_trained_params)."""
        from mst_torch.runtime.checkpoint import load_trained_params

        device = resolve_device(device)
        state_dict, step = load_trained_params(directory)
        if state_dict is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        model = StyleTransferModel(config)
        model.load_state_dict(state_dict)
        return cls(model=model, device=device,
                   extract_storage_dtype=extract_storage_dtype)


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


def _compact(word, n_channels, n_bars):
    """Ordered compaction of B jobs' packed words (B, C, R, T, F10, N):
    cells of channel >= n_channels[b] or bar >= n_bars[b] are masked, and
    the nonzero words come back as per-job (cell, word) records in
    ascending cell order — the records of mst_tpu's _compact_song, from one
    ordered ``torch.nonzero``. Returns (counts (B,), cells (K,), words (K,))
    with job b's records at [sum(counts[:b]), sum(counts[:b+1]))."""
    B, C, R = word.shape[:3]
    dev = word.device
    c_ok = torch.arange(C, device=dev)[None] < n_channels[:, None]
    r_ok = torch.arange(R, device=dev)[None] < n_bars[:, None]
    valid = (c_ok[:, :, None] & r_ok[:, None, :]).reshape(
        B, C, R, *([1] * (word.dim() - 3)))
    flat = torch.where(valid, word, torch.zeros_like(word)).reshape(B, -1)
    nz = torch.nonzero(flat)                      # row-major: job, then cell
    counts = torch.bincount(nz[:, 0], minlength=B)
    return counts, nz[:, 1], flat[nz[:, 0], nz[:, 1]]


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
    """Latents of B songs sharing one (Cb, Rb, T) bucket."""

    style: torch.Tensor    # (B, S)
    melody: torch.Tensor   # (B, Rb, T, 10, 56, melody_size)
    rhythm: torch.Tensor   # (B, Rb, T, 10, rhythm_size)
    n_bars: List[int]      # per-song real bar count


def _extract_inputs(bundle: ModelBundle, songs: Sequence[Song], T: int,
                    has_unpitched: bool):
    """Device inputs of one extraction batch (mst_tpu's _extract_inputs):
    every song's quantized note records are offset into one flat row space
    (song b = channel block b*Cb..), so one scatter materializes the whole
    (B, Cb, Rb, ...) raster batch. Returns (inputs dict, per-song real bar
    counts)."""
    dev = bundle.device
    B = len(songs)
    caps = [1000 // s.n_channels for s in songs]
    Cs = [s.pitched_shape[0] for s in songs]
    Rs = [min(s.pitched_shape[1], cap) for s, cap in zip(songs, caps)]
    Cb = _bucket(max(Cs), CHANNEL_BUCKETS)
    Rb = _bucket(max(Rs), BAR_BUCKETS)

    def records(pitched):
        parts = []
        for b, song in enumerate(songs):
            rasterizer = Rasterizer(song.info)
            note_arrays = (song.pitched_notes if pitched
                           else song.unpitched_notes)
            n_channels = Cb if pitched else 1
            for c, n in enumerate(note_arrays[:n_channels]):
                q = rasterizer.quantize(n, pitched)
                parts.append(encode_notes(
                    rasterizer, q, b * n_channels + c, pitched,
                    B * n_channels, Rb, valid_bars=Rs[b]))
        return concat_and_pad(parts).to(dev)

    instf = np.zeros((B, Cb, songs[0].instruments_features.shape[-1]),
                     np.float32)
    cmask = np.zeros((B, Cb), np.float32)
    mode = np.zeros((B, 2), np.float32)
    bpm = np.full((B,), 120.0, np.float32)
    for b, song in enumerate(songs):
        instf[b, :Cs[b]] = song.instruments_features
        cmask[b, :Cs[b]] = 1.0
        mode[b] = [0.0, 1.0] if song.info.scale.is_minor else [1.0, 0.0]
        bpm[b] = song.info.bpm
    inputs = dict(
        p_notes=records(True),
        u_notes=records(False) if has_unpitched else None,
        mode=torch.from_numpy(mode).to(dev),
        bpm=torch.from_numpy(bpm).to(dev),
        instf=torch.from_numpy(instf).to(dev),
        lengths=torch.tensor(Rs, dtype=torch.int64, device=dev),
        cmask=torch.from_numpy(cmask).to(dev),
        # parity: prepare_input passes percussion whenever present, even
        # all-zero (style_transfer.py:70-73)
        umask=(torch.ones((B, 1), dtype=torch.float32, device=dev)
               if has_unpitched else None),
        B=B, Cb=Cb, Rb=Rb, T=T)
    return inputs, Rs


def _raster_extract_latents(model: StyleTransferModel, p_notes, u_notes,
                            mode, bpm, instf, lengths, cmask, umask, *, B,
                            Cb, Rb, T):
    """On-device rasterization of both note families (K1) + the latent
    extractor for a batch of B songs (mst_tpu's _raster_extract_latents).
    K1 writes the rasters at the storage dtype in force. The raster stays
    NF-fused, (…, 56*5); the model splits it."""
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
    percussion presence), and each group is one bucket-padded batch. Returns
    (batches, locators): a list of LatentBatch plus, per input song, its
    (batch_index, row)."""
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
        inputs, Rs = _extract_inputs(bundle, [songs[i] for i in members], T,
                                     has_unpitched)
        with bundle.policy(bundle.extract_storage_dtype):
            style, melody, rhythm = _raster_extract_latents(bundle.model,
                                                            **inputs)
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


def apply_jobs(bundle: ModelBundle, infos, style_mat, melody_mat, rhythm_mat,
               style_idx, comp_idx, n_instruments_list, n_bars_list,
               host_work=None):
    """The device side of B (style row, composition row) jobs (mst_tpu's
    _fused_transfer_apply): latent gathers, song-info prediction, the
    instrument pick and feature gather, both appliers, packing and
    compaction. ``host_work`` runs once the device work is queued and before
    its results are read. Returns per-job views ``(header (6,) uint32 —
    mst_tpu's header fields (transfer.py:108) [bpm, mode, n_picked,
    has_unpitched, count_p, count_u] without its TPU routing counts,
    picked (Cb,) int32, rec_p (count_p, 2) uint32, rec_u (count_u, 2)
    uint32)`` and the apply channel bucket Cb. Runs at fp32 storage."""
    with bundle.policy():
        return _apply_jobs(bundle, infos, style_mat, melody_mat, rhythm_mat,
                           style_idx, comp_idx, n_instruments_list,
                           n_bars_list, host_work)


def _apply_jobs(bundle, infos, style_mat, melody_mat, rhythm_mat, style_idx,
                comp_idx, n_instruments_list, n_bars_list, host_work):
    dev = bundle.device
    model = bundle.model
    B = len(infos)
    Cb = _bucket(max(max(n_instruments_list), 1), CHANNEL_BUCKETS)

    def rows(values, dtype):
        return torch.tensor(list(values), dtype=dtype, device=dev)

    tpb = rows([i.ticks_per_beat for i in infos], torch.float32)
    n_inst = rows(n_instruments_list, torch.int64)
    bars = rows(n_bars_list, torch.int64)
    style = style_mat[rows(style_idx, torch.int64)]
    melody = melody_mat[rows(comp_idx, torch.int64)]
    rhythm = rhythm_mat[rows(comp_idx, torch.int64)]

    inst_logits, mode_pred, bpm_pred = model.predict_song_info(
        style, rhythm, bar_lengths=bars)
    picked, n_picked, has_unpitched = _pick_instruments(inst_logits, n_inst,
                                                        Cb)
    instf = torch.where((picked >= 0)[..., None],
                        bundle._feature_table[picked.clamp(min=0)], 0.0)
    x_p, x_u = model.apply_style(style, melody, rhythm, instf, True)
    if host_work is not None:
        host_work()      # overlaps the queued device work above
    tpb_b = tpb.reshape((B,) + (1,) * 5)
    count_p, cell_p, word_p = _compact(_pack_word(x_p, tpb_b), n_picked,
                                       bars)
    count_u, cell_u, word_u = _compact(_pack_word(x_u, tpb_b),
                                       has_unpitched.to(torch.int64), bars)
    header = torch.stack([
        torch.round(bpm_pred).to(torch.int64),
        torch.argmax(mode_pred, dim=-1),
        n_picked, has_unpitched.to(torch.int64), count_p, count_u], dim=1)

    header, picked = header.cpu().numpy(), picked.cpu().numpy()
    rec_p = np.stack([cell_p.cpu().numpy(), word_p.cpu().numpy()], axis=1)
    rec_u = np.stack([cell_u.cpu().numpy(), word_u.cpu().numpy()], axis=1)
    rec_p, rec_u = rec_p.astype(np.uint32), rec_u.astype(np.uint32)
    views = []
    off_p = off_u = 0
    for b in range(B):
        cp, cu = int(header[b, 4]), int(header[b, 5])
        views.append((header[b].astype(np.uint32),
                      picked[b].astype(np.int32),
                      rec_p[off_p:off_p + cp], rec_u[off_u:off_u + cu]))
        off_p += cp
        off_u += cu
    return views, Cb


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

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    mid = create_midi(rasterizer.info.as_create_midi_info(),
                      *instruments_data, max_delta_time=1)
    native.write_midi_file(save_path, mid)


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
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    mid = create_midi(rasterizer.info.as_create_midi_info(),
                      *instruments_data, max_delta_time=1)
    native.write_midi_file(save_path, mid)


def _decode_packed_job(info: SongInfo, header: np.ndarray, picked_all,
                       rec_p: np.ndarray, rec_u: np.ndarray, Cb: int, Rb: int,
                       T: int, save_path: str) -> None:
    """Decode one job's records (one ``apply_jobs`` view) to a .mid file
    (mst_tpu/transfer.py:1140-1192)."""
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
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    mid = create_midi(rasterizer.info.as_create_midi_info(),
                      *instruments_data, max_delta_time=1)
    native.write_midi_file(save_path, mid)


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
    (Rb, T) bucket run as one ``apply_jobs`` batch; job b is written to
    ``save_paths[b]``. Like mst_tpu's, the decode sets each info's tempo
    and scale to the predicted ones."""
    strict_fp32()
    dev = bundle.device

    def batch(parts):
        return torch.cat([torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in parts], dim=0)

    style, melody, rhythm = batch(styles), batch(melodies), batch(rhythms)
    idx = list(range(len(infos)))
    with torch.inference_mode():
        views, Cb = apply_jobs(bundle, list(infos), style, melody, rhythm,
                               idx, idx, n_instruments_list, n_bars_list)
    for info, view, path in zip(infos, views, save_paths):
        _decode_packed_job(info, *view, Cb, rhythm.shape[1], rhythm.shape[2],
                           path)


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


def transfer_styles(bundle: ModelBundle, composition_paths, style_paths,
                    output_path) -> List[str]:
    """Batched transfer_style over many compositions (same per-song outputs
    and file layout as mst_tpu.transfer.transfer_styles).

    All compositions and styles are latent-extracted in batches grouped by
    (beats-per-bar, percussion presence); all (reconstructed + styled) apply
    jobs of one composition group run as one batch."""
    strict_fp32()
    all_paths = list(composition_paths) + list(style_paths)
    if not all_paths:
        return []
    loaded = list(ingest_map(get_model_input, all_paths))
    bad = [p for p, s in zip(all_paths, loaded) if s is None]
    if bad:
        raise MidiFormatError(
            f"could not load {len(bad)} input file(s): {bad}")
    songs = [s for _, s in loaded]
    comps = songs[:len(composition_paths)]
    style_songs = songs[len(composition_paths):]

    with torch.inference_mode():
        batches, locators = extract_styles(bundle, comps + style_songs)
    comp_loc = locators[:len(comps)]
    style_loc = locators[len(comps):]
    # global style-vector matrix: batch g's rows start at style_offset[g]
    style_offset = np.cumsum([0] + [b.style.shape[0] for b in batches])
    style_mat = torch.cat([b.style for b in batches], dim=0)

    def style_row(loc):
        return int(style_offset[loc[0]]) + loc[1]

    names = [os.path.splitext(os.path.basename(str(p)))[0]
             for p in composition_paths]
    style_names = [os.path.splitext(os.path.basename(str(p)))[0]
                   for p in style_paths]

    def decode_originals():
        """Host-side decode of the ingested tensors to the original/ files."""
        style_original_bytes = [None] * len(style_songs)
        for i, comp in enumerate(comps):
            out_dir = os.path.join(str(output_path), names[i])
            original = os.path.join(out_dir, f"original/{names[i]}.mid")
            save_channels(Rasterizer(comp.info), comp.pitched, comp.unpitched,
                          comp.instruments, original)
            for j, style_song in enumerate(style_songs):
                path = os.path.join(out_dir, f"original/{style_names[j]}.mid")
                if style_original_bytes[j] is None:
                    # decode each style original ONCE; later comps copy bytes
                    save_channels(Rasterizer(style_song.info),
                                  style_song.pitched, style_song.unpitched,
                                  style_song.instruments, path)
                    with open(path, "rb") as fh:
                        style_original_bytes[j] = fh.read()
                else:
                    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                    with open(path, "wb") as fh:
                        fh.write(style_original_bytes[j])

    written_per_comp = [[os.path.join(str(output_path), names[i],
                                      f"original/{names[i]}.mid")]
                        for i in range(len(comps))]
    # apply jobs, grouped by the composition's latent batch (shared Rb/T)
    jobs_per_group = {}
    for i, comp in enumerate(comps):
        g, row = comp_loc[i]
        out_dir = os.path.join(str(output_path), names[i])
        jobs = jobs_per_group.setdefault(g, [])
        reconstructed = os.path.join(out_dir,
                                     f"{names[i]} (reconstructed).mid")
        jobs.append((style_row(comp_loc[i]), row, comp.info,
                     len(comp.instruments), batches[g].n_bars[row],
                     reconstructed))
        written_per_comp[i].append(reconstructed)
        for j, style_song in enumerate(style_songs):
            info = combine_info(style_info=style_song.info,
                                melody_info=comp.info)
            path = os.path.join(
                out_dir, f"{names[i]} ({style_names[j]} style).mid")
            jobs.append((style_row(style_loc[j]), row, info,
                         len(style_song.instruments),
                         batches[g].n_bars[row], path))
            written_per_comp[i].append(
                os.path.join(out_dir, f"original/{style_names[j]}.mid"))
            written_per_comp[i].append(path)

    host_work = decode_originals
    for g, jobs in jobs_per_group.items():
        s_idx, c_idx, infos, n_inst, bars, paths = zip(*jobs)
        rhythm = batches[g].rhythm
        with torch.inference_mode():
            views, Cb = apply_jobs(bundle, list(infos), style_mat,
                                   batches[g].melody, rhythm, s_idx, c_idx,
                                   n_inst, bars, host_work=host_work)
        host_work = None
        for b, view in enumerate(views):
            _decode_packed_job(infos[b], *view, Cb, rhythm.shape[1],
                               rhythm.shape[2], paths[b])
    if host_work is not None:  # no apply jobs at all
        host_work()
    return [p for per_comp in written_per_comp for p in per_comp]


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
