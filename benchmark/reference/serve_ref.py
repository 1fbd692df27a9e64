"""The plain reference of a transfer request, and the comparison that
judges the ``.mid`` files a served request wrote.

The reference works everything out again from the MIDI bytes that the
benchmark generated, with the frozen copy of the port's host code and
model layers (``mstref``): SMF parse, key detection and quantization, the
dense rasters (numpy, not K1), the extraction, song info, the instrument
pick, both appliers with the note-grid tail in plain torch, and the hard
output decoded to the files that ``transfer_styles`` writes. It batches a
request's songs and jobs as the port does (one extraction batch at the
request's channel and bar buckets), so both sides meet the same shapes.

``judge`` compares one served request with the reference:

- the originals (the host's decode of each ingested song) must be byte
  equal to the reference's: an exact comparison;
- each reconstructed and styled file is compared with the reference's
  continuous outputs. A file byte-equal to the reference's decode reads
  0. Otherwise every decision the served file shows and the reference
  does not make (a note on or off, its velocity byte, its accidental, its
  duration in ticks, the tempo, the mode, the instruments) is charged the
  distance by which the reference's own value lies outside the region
  that gives the served decision: the velocity against the 0.01 gate and
  the ``int(v*127)`` steps, the duration (beats) against the
  ``int(d*tpb)`` steps, the accidental outputs against the 0.1 gate and
  the argmax, the predicted bpm (relative) against its rounding, the mode
  and instrument logits against the served choice. A decision that no
  reference value near it explains is charged 1. The number compared is
  the widest such gap over the sampled requests: two fp32 programs that
  sum in another order flip only decisions that lie within rounding of a
  boundary, while a lower precision or a wrong answer flips decisions far
  from one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference.mstref.config import ModelConfig
from benchmark.reference.mstref.data.pipeline import Song, get_input
from benchmark.reference.mstref.data.taxonomy import (
    INCLUDED_INSTRUMENTS, PERCUSSION_ID, category_feature_table,
    category_instrument)
from benchmark.reference.mstref.io import smf
from benchmark.reference.mstref.io.midi import bpm2tempo, create_midi
from benchmark.reference.mstref.models import StyleTransferModel
from benchmark.reference.mstref.ops.events import SongInfo, read_midi
from benchmark.reference.mstref.ops.rasterize import Rasterizer
from benchmark.reference.mstref.theory import degree_tables
from benchmark.reference.mstref.theory.scales import Scale
from benchmark.reference.mstref import weights

CHANNEL_BUCKETS = (8, 16, 32)
BAR_BUCKETS = (64, 96, 128, 160, 192, 256, 320, 384, 512, 768, 1024)
NOTE_BUCKETS = (512, 2048, 8192, 32768, 131072)
UNEXPLAINED = 1.0        # the gap of a decision no reference value explains
_PROGRAM_TO_CATEGORY = {category_instrument(i): i
                        for i in range(len(INCLUDED_INSTRUMENTS))}


def bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def ingest(data: bytes) -> Song:
    """One song from its SMF bytes (the port's ``get_model_input``)."""
    channels, info = read_midi(smf.parse_midi_bytes(data))
    allowed = set([-1, *INCLUDED_INSTRUMENTS])
    channels = [c for c in channels if c["instrument_id"] in allowed]
    return get_input(channels, info)


def host_key(songs: Sequence[Song]):
    """(T, has percussion, Cb, Rb, pitched record bucket, unpitched record
    bucket) of a request's songs: the shapes its extraction program takes
    (the port's ``_extract_shards``)."""
    Cs = [s.pitched_shape[0] for s in songs]
    Rs = [min(s.pitched_shape[1], 1000 // s.n_channels) for s in songs]
    Cb = bucket(max(Cs), CHANNEL_BUCKETS)
    n_p = sum(len(n.note_id) for s in songs for n in s.pitched_notes[:Cb])
    n_u = sum(len(n.note_id) for s in songs for n in s.unpitched_notes[:1])
    return (songs[0].info.n_beats, songs[0].unpitched_shape is not None, Cb,
            bucket(max(Rs), BAR_BUCKETS), bucket(n_p, NOTE_BUCKETS),
            bucket(n_u, NOTE_BUCKETS))


def load_model(npz_path: str, device, config: ModelConfig = ModelConfig()):
    model = StyleTransferModel(config)
    model.load_state_dict(weights.state_dict_from_flax(
        weights.load_npz(npz_path)))
    return model.to(device).eval()


@dataclasses.dataclass
class Job:
    style_row: int
    comp_row: int
    info: SongInfo
    n_instruments: int
    n_bars: int
    name: str             # the file's name, relative to the output dir


def plan(comp_names, style_names, comps, styles, Rs) -> List[Job]:
    """The request's jobs in ``transfer_styles``' order: each
    composition's reconstruction, then one job per style."""
    jobs = []
    nc = len(comps)
    for i, comp in enumerate(comps):
        jobs.append(Job(i, i, dataclasses.replace(comp.info),
                        len(comp.instruments), Rs[i],
                        f"{comp_names[i]}/{comp_names[i]} (reconstructed).mid"))
        for j, style in enumerate(styles):
            info = dataclasses.replace(comp.info, tempo=style.info.tempo,
                                       scale=style.info.scale, duration=None)
            jobs.append(Job(nc + j, i, info, len(style.instruments), Rs[i],
                            f"{comp_names[i]}/{comp_names[i]} "
                            f"({style_names[j]} style).mid"))
    return jobs


def extraction_inputs(songs: Sequence[Song], device):
    """The extraction batch as the port builds it, with dense host rasters
    in place of K1: (mode, bpm, pitched, instf, unpitched, lengths, cmask,
    umask), Rs."""
    B = len(songs)
    Cs = [s.pitched_shape[0] for s in songs]
    Rs = [min(s.pitched_shape[1], 1000 // s.n_channels) for s in songs]
    Cb = bucket(max(Cs), CHANNEL_BUCKETS)
    Rb = bucket(max(Rs), BAR_BUCKETS)
    T = songs[0].info.n_beats
    has_u = songs[0].unpitched_shape is not None
    pitched = np.zeros((B, Cb, Rb, T, 10, 56, 5), np.float32)
    unpitched = np.zeros((B, 1, Rb, T, 10, 47, 2), np.float32) if has_u \
        else None
    instf = np.zeros((B, Cb, songs[0].instruments_features.shape[-1]),
                     np.float32)
    cmask = np.zeros((B, Cb), np.float32)
    mode = np.zeros((B, 2), np.float32)
    bpm = np.zeros((B,), np.float32)
    for b, s in enumerate(songs):
        c = min(Cs[b], Cb)
        pitched[b, :c, :Rs[b]] = s.pitched[:c, :Rs[b]]
        if has_u and s.unpitched is not None:
            unpitched[b, :1, :Rs[b]] = s.unpitched[:1, :Rs[b]]
        instf[b, :Cs[b]] = s.instruments_features
        cmask[b, :Cs[b]] = 1.0
        mode[b] = [0.0, 1.0] if s.info.scale.is_minor else [1.0, 0.0]
        bpm[b] = s.info.bpm

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return (t(mode), t(bpm), t(pitched.reshape(B, Cb, Rb, T, 10, 280)),
            t(instf),
            None if unpitched is None else
            t(unpitched.reshape(B, 1, Rb, T, 10, 94)),
            t(Rs, torch.int64), t(cmask),
            t(np.ones((B, 1), np.float32)) if has_u else None), Rs


def pick_instruments(logits, n_instruments, max_channels: int):
    """The port's top-n instrument pick (a stable descending sort; a
    percussion-only pick of one widens to two)."""
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


@dataclasses.dataclass
class JobOutput:
    """The reference's continuous outputs of one job, on the host."""

    x_p: np.ndarray          # (Cb, Rb, T, 10, 56, 5) fp32
    x_u: np.ndarray          # (1, Rb, T, 10, 47, 2) fp32
    inst_logits: np.ndarray  # (41,)
    mode_logits: np.ndarray  # (2,)
    bpm: float
    picked: List[int]        # categories
    has_unpitched: bool


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 matmuls and convolutions with TF32 off (the reference), or on
    (the control); the flags are put back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Reference:
    """The reference model of one configuration on ``device``, in fp32
    with TF32 off; ``tf32=True`` makes it the control."""

    def __init__(self, npz_path: str, device, config=ModelConfig(),
                 tf32: bool = False):
        self.device = torch.device(device)
        self.model = load_model(npz_path, self.device, config)
        self.table = torch.as_tensor(category_feature_table(),
                                     device=self.device)
        self.tf32 = tf32

    @torch.no_grad()
    def extract(self, songs: Sequence[Song]):
        with matmul_precision(self.tf32):
            return self._extract(songs)

    def _extract(self, songs: Sequence[Song]):
        inputs, Rs = extraction_inputs(songs, self.device)
        mode, bpm, pitched, instf, unpitched, lengths, cmask, umask = inputs
        latents = self.model.extract_style(
            mode, bpm, pitched, instf, unpitched, bar_lengths=lengths,
            channel_mask=cmask, uchannel_mask=umask)
        return latents, Rs, pitched.shape[1]

    @torch.no_grad()
    def apply(self, latents, jobs: Sequence[Job], Cb: int,
              picked_override=None) -> List[JobOutput]:
        """Song info, the pick and both appliers for ``jobs`` (one batch);
        ``picked_override``: (B, Cb) categories to use in place of the
        pick (to follow a served file's instruments)."""
        with matmul_precision(self.tf32):
            return self._apply(latents, jobs, Cb, picked_override)

    def _apply(self, latents, jobs, Cb, picked_override):
        style, melody, rhythm = latents
        dev = self.device
        s_idx = torch.tensor([j.style_row for j in jobs], device=dev)
        c_idx = torch.tensor([j.comp_row for j in jobs], device=dev)
        n_inst = torch.tensor([j.n_instruments for j in jobs], device=dev)
        bars = torch.tensor([j.n_bars for j in jobs], device=dev)
        st, mel, rh = style[s_idx], melody[c_idx], rhythm[c_idx]
        inst_logits, mode_pred, bpm_pred = self.model.predict_song_info(
            st, rh, bar_lengths=bars)
        picked, n_picked, has_u = pick_instruments(inst_logits, n_inst, Cb)
        if picked_override is not None:
            picked = torch.as_tensor(picked_override, device=dev)
        instf = torch.where((picked >= 0)[..., None],
                            self.table[picked.clamp(min=0)], 0.0)
        x_p, x_u = self.model.apply_style(st, mel, rh, instf, True)
        out = []
        for b in range(len(jobs)):
            out.append(JobOutput(
                x_p=x_p[b].float().cpu().numpy(),
                x_u=x_u[b].float().cpu().numpy(),
                inst_logits=inst_logits[b].float().cpu().numpy(),
                mode_logits=mode_pred[b].float().cpu().numpy(),
                bpm=float(bpm_pred[b]),
                picked=[int(p) for p in picked[b].tolist() if p >= 0],
                has_unpitched=bool(has_u[b])))
        return out


# ---- decode (the port's hard output and file layout) ----

def _free_channels(n: int) -> List[int]:
    return [i for i in range(16) if i != 9][:n]


def original_bytes(song: Song) -> bytes:
    """The host's decode of an ingested song (``save_channels``)."""
    rasterizer = Rasterizer(song.info)
    data = []
    ids = _free_channels(song.pitched.shape[0])
    for idx, inst in zip(range(song.pitched.shape[0]), song.instruments):
        data.append({"channel_id": ids[idx], "instrument_id": int(inst),
                     "messages": rasterizer.messages_from_raster(
                         song.pitched[idx], pitched=True, hard=True)})
    if song.unpitched is not None:
        data.append({"channel_id": 9, "instrument_id": -1,
                     "messages": rasterizer.messages_from_raster(
                         song.unpitched[0], pitched=False, hard=True)})
    return smf.encode_midi(create_midi(
        rasterizer.info.as_create_midi_info(), *data, max_delta_time=1))


def decided_info(info: SongInfo, bpm: int, minor: bool) -> SongInfo:
    return dataclasses.replace(
        info, tempo=bpm2tempo(int(bpm)),
        scale=Scale(tonic=info.scale.tonic, is_minor=bool(minor)))


def _job_midi(info: SongInfo, out: JobOutput, n_bars: int, picked,
              has_unpitched: bool, max_delta_time: float = 1.0):
    rasterizer = Rasterizer(info)
    data = []
    ids = _free_channels(len(picked))
    for c, cat in enumerate(picked):
        data.append({"channel_id": ids[c],
                     "instrument_id": category_instrument(cat),
                     "messages": rasterizer.messages_from_raster(
                         out.x_p[c, :n_bars], pitched=True, hard=True)})
    if has_unpitched:
        data.append({"channel_id": 9, "instrument_id": -1,
                     "messages": rasterizer.messages_from_raster(
                         out.x_u[0, :n_bars], pitched=False, hard=True)})
    return create_midi(info.as_create_midi_info(), *data,
                       max_delta_time=max_delta_time)


def job_bytes(info: SongInfo, out: JobOutput, n_bars: int, picked,
              has_unpitched: bool) -> bytes:
    """The file of one job from the reference's outputs and the given
    decisions (``info`` already carries the tempo and scale); as the port
    writes it, each delta capped at one second."""
    return smf.encode_midi(_job_midi(info, out, n_bars, picked,
                                     has_unpitched))


# ---- the comparison ----

def _note_events(track):
    """[(delta, is_on, channel, key, velocity)] of a track's note events,
    each delta counted from the previous note event."""
    out, pending = [], 0
    for i in range(len(track)):
        ev = int(track.type[i])
        pending += int(track.delta[i])
        if ev in (smf.EV_NOTE_ON, smf.EV_NOTE_OFF):
            vel = int(track.b[i])
            on = ev == smf.EV_NOTE_ON and vel > 0
            out.append((pending, on, int(track.channel[i]),
                        int(track.a[i]), vel if on else 0))
            pending = 0
    return out


def _file_facts(data: bytes):
    """(tempo, {channel: program}, note events) of a served file."""
    parsed = smf.parse_midi_bytes(data)
    tempo, programs = None, {}
    track = parsed.tracks[0]
    for i in range(len(track)):
        ev = int(track.type[i])
        if ev == smf.EV_TEMPO:
            tempo = int(track.a[i])
        elif ev == smf.EV_PROGRAM:
            programs[int(track.channel[i])] = int(track.a[i])
    return tempo, programs, _note_events(track)


def _true_events(info, out, n_bars, picked, has_u):
    """The reference's note events at their true times (no delta cap):
    [(t, is_on, channel, key, velocity)]."""
    track = _job_midi(info, out, n_bars, picked, has_u,
                      max_delta_time=float("inf")).tracks[0]
    t, events = 0, []
    for delta, on, ch, key, vel in _note_events(track):
        t += delta
        events.append((t, on, ch, key, vel))
    return events


def served_times(served, expected, cap: int):
    """The true time of each served note event (None where it cannot be
    told). The served file caps every delta at ``cap`` ticks, so its
    cumulative times drift after a long silence. The events are aligned
    with the reference's by what they are (on/off, channel, key,
    velocity); an aligned pair whose times agree with the previous anchor
    is an anchor, and every other served event takes its time from the
    nearest anchor before it or after it across deltas that were not
    capped."""
    import difflib
    sig_s = [e[1:] for e in served]
    sig_e = [e[1:] for e in expected]
    pairs = []
    matcher = difflib.SequenceMatcher(None, sig_s, sig_e, autojunk=False)
    for block in matcher.get_matching_blocks():
        pairs += [(block.a + k, block.b + k) for k in range(block.size)]
    deltas = [e[0] for e in served]
    capped = [d >= cap for d in deltas]
    anchors = {}
    last = None        # (served index, true time)
    for i, j in pairs:
        t = expected[j][0]
        if last is None:
            ok = sum(deltas[:i + 1]) == t or (any(capped[:i + 1])
                                              and sum(deltas[:i + 1]) <= t)
        else:
            span = deltas[last[0] + 1:i + 1]
            gap = t - last[1]
            ok = sum(span) == gap or (any(d >= cap for d in span)
                                      and sum(span) <= gap)
        if ok:
            anchors[i] = t
            last = (i, t)
    times = [None] * len(served)
    prev = None
    for i in range(len(served)):
        if i in anchors:
            times[i] = anchors[i]
            prev = i
            continue
        if prev is None:
            span = deltas[:i + 1]
            if not any(capped[:i + 1]):
                times[i] = sum(span)
        elif not any(capped[prev + 1:i + 1]):
            times[i] = anchors[prev] + sum(deltas[prev + 1:i + 1])
    nxt = None
    for i in range(len(served) - 1, -1, -1):
        if i in anchors:
            nxt = i
            continue
        if times[i] is None and nxt is not None and \
                not any(capped[i + 1:nxt + 1]):
            times[i] = anchors[nxt] - sum(deltas[i + 1:nxt + 1])
    return times


def _interval_gap(x: float, lo: float, hi: float) -> float:
    """How far x lies outside [lo, hi)."""
    return max(0.0, lo - x, x - hi)


def _acc_gap(a, code: int) -> float:
    """The least change of the accidental outputs (flat, natural, sharp)
    that makes the hard output pick ``code`` (0 flat, 1 natural or none,
    2 sharp; flat > natural > sharp on ties, none above 0.1 -> natural)."""
    a0, a1, a2 = (float(v) for v in a)
    if code == 0:
        return max(0.0, (max(a1, a2) - a0) / 2, 0.1 - a0)
    if code == 2:
        return max(0.0, (max(a0, a1) - a2) / 2, 0.1 - a2)
    natural = max(0.0, (max(a0, a2) - a1) / 2, 0.1 - a1)
    none = max(0.0, max(a0, a1, a2) - 0.1)
    return min(natural, none)


def _vel_gap(v: float, vel_byte: int) -> float:
    return _interval_gap(v, max(vel_byte / 127.0, 0.01),
                         (vel_byte + 1) / 127.0)


def _dur_gap(d: float, ticks: int, tpb: int) -> float:
    lo = -np.inf if ticks <= 0 else ticks / tpb
    hi = np.inf if ticks >= 65535 else (ticks + 1) / tpb
    return _interval_gap(d, lo, hi)


class _Cells:
    """The reference's cells of one job that could give a note, indexed by
    (onset tick, channel id)."""

    def __init__(self, info: SongInfo, out: JobOutput, n_bars: int,
                 n_channels: int, has_unpitched: bool):
        rasterizer = Rasterizer(info)
        frac_ticks = rasterizer.grid.frac_ticks(info.ticks_per_beat)
        scale = info.scale
        self.slots = collections.defaultdict(list)
        ids = _free_channels(n_channels)
        fams = [(out.x_p[c, :n_bars], ids[c], True)
                for c in range(n_channels)]
        if has_unpitched:
            fams.append((out.x_u[0, :n_bars], 9, False))
        for x, ch, pitched in fams:
            v = x[..., 1]
            bar, beat, frac, nidx = np.nonzero(v > 1e-4)
            cells = x[bar, beat, frac, nidx]
            t = (bar * info.ticks_per_bar + beat * info.ticks_per_beat
                 + frac_ticks[frac])
            if pitched:
                keys = np.stack([degree_tables.scale_loc_to_note(
                    (nidx // 7).astype(np.int64), (nidx % 7).astype(np.int64),
                    np.full(nidx.shape, code, np.int64), scale.tonic,
                    scale.is_minor) for code in range(3)], axis=1)
            else:
                keys = np.repeat((nidx + rasterizer.rep.min_percussion)
                                 [:, None], 3, axis=1)
            for i in range(len(t)):
                self.slots[(int(t[i]), ch)].append(
                    (keys[i], cells[i], pitched))

    def gap(self, key: int, vel: int, cell) -> float:
        keys, x, pitched = cell
        if pitched:
            acc = min((_acc_gap(x[2:5], c) for c in range(3)
                       if keys[c] == key), default=None)
        else:
            acc = 0.0 if keys[0] == key else None
        if acc is None:
            return UNEXPLAINED
        return max(acc, _vel_gap(float(x[1]), vel))

    @staticmethod
    def off_gap(x) -> float:
        """How far the cell's velocity lies above the gate."""
        return max(0.0, float(x[1]) - 0.01)


def notes_gap(served_events, times, expected, cells: _Cells,
              tpb: int) -> float:
    """The widest gap of the served file's notes (``served_events`` with
    their true ``times``) against the reference (``expected``: its note
    events at true times under the served song-level decisions)."""
    s_on = collections.defaultdict(list)
    s_off = collections.defaultdict(list)
    worst = 0.0
    for (_, on, ch, key, vel), t in zip(served_events, times):
        if t is None:
            return UNEXPLAINED
        if on:
            s_on[(t, ch)].append((key, vel))
        else:
            s_off[(ch, key)].append(t)
    e_on = collections.defaultdict(list)
    e_off = collections.defaultdict(list)
    for t, on, ch, key, vel in expected:
        if on:
            e_on[(t, ch)].append((key, vel))
        else:
            e_off[(ch, key)].append(t)
    served_cells = collections.defaultdict(list)   # (ch, key) -> [(t, x)]
    for slot in set(s_on) | set(e_on):
        s = sorted(s_on.get(slot, []))
        e = sorted(e_on.get(slot, []))
        candidates = list(cells.slots.get(slot, []))
        for key, vel in s:
            gaps = [cells.gap(key, vel, c) for c in candidates]
            if not gaps:
                worst = max(worst, UNEXPLAINED)
                continue
            best = int(np.argmin(gaps))
            if s != e:
                worst = max(worst, gaps[best])
            served_cells[(slot[1], key)].append(
                (slot[0], candidates.pop(best)[1]))
        if s != e:
            # cells the reference turns on that the served file left off
            for _, x, _ in candidates:
                if float(x[1]) > 0.01:
                    worst = max(worst, cells.off_gap(x))
    for group in set(s_off) | set(e_off):
        extra = (collections.Counter(s_off.get(group, []))
                 - collections.Counter(e_off.get(group, [])))
        notes = served_cells.get(group, [])
        for t_off in extra.elements():
            gaps = [_dur_gap(float(x[0]), t_off - t_on, tpb)
                    for t_on, x in notes if t_on < t_off]
            worst = max(worst, min(gaps, default=UNEXPLAINED))
    return worst


def judge_job(served: bytes, job: Job, out: JobOutput, redo=None) -> float:
    """The gap of one served reconstructed or styled file. ``redo(cats)``
    gives the reference's outputs of this job under another instrument
    pick (the served file's), when that differs."""
    ref_bpm = int(torch.round(torch.tensor(out.bpm, dtype=torch.float32)))
    ref_minor = bool(np.argmax(out.mode_logits) == 1)
    expected = job_bytes(decided_info(job.info, ref_bpm, ref_minor), out,
                         job.n_bars, out.picked, out.has_unpitched)
    if served == expected:
        return 0.0
    try:
        tempo, programs, events = _file_facts(served)
    except smf.MidiParseError:
        return UNEXPLAINED
    gap = 0.0
    # tempo: the served bpm, and the reference's distance from its rounding
    served_bpm = None
    if tempo:
        base = 6e7 / tempo
        for b in range(max(1, int(base) - 2), int(base) + 3):
            if bpm2tempo(b) == tempo:
                served_bpm = b
                break
    if served_bpm is None:
        return UNEXPLAINED
    gap = max(gap, _interval_gap(out.bpm, served_bpm - 0.5, served_bpm + 0.5)
              / max(abs(out.bpm), 1.0))
    # instruments: the served programs in channel order
    cats = []
    for ch in _free_channels(16):
        if ch in programs:
            cat = _PROGRAM_TO_CATEGORY.get(programs[ch])
            if cat is None:
                return UNEXPLAINED
            cats.append(cat)
    has_u = any(e[2] == 9 for e in events) or out.has_unpitched
    if cats != out.picked:
        logits = out.inst_logits
        n = max(len(cats), len(out.picked))
        ref = out.picked + [PERCUSSION_ID] * (n - len(out.picked))
        mine = cats + [PERCUSSION_ID] * (n - len(cats))
        gap = max(gap, max(abs(float(logits[a]) - float(logits[b]))
                           for a, b in zip(ref, mine)))
        if redo is None:
            return max(gap, UNEXPLAINED)
        out = redo(cats)
    tpb = job.info.ticks_per_beat
    cap = int(1.0 / (tempo * 1e-6 / tpb))
    # mode: judge the notes under each mode, charging the mode's margin
    ref_minor = bool(np.argmax(out.mode_logits) == 1)
    best = None
    for minor in (ref_minor, not ref_minor):
        margin = 0.0
        if minor != ref_minor:
            margin = abs(float(out.mode_logits[1] - out.mode_logits[0]))
            if best is not None and best <= margin:
                break
        info = decided_info(job.info, served_bpm, minor)
        expected = _true_events(info, out, job.n_bars, cats, has_u)
        times = served_times(events, expected, cap)
        cells = _Cells(info, out, job.n_bars, len(cats), has_u)
        g = max(margin, notes_gap(events, times, expected, cells, tpb))
        best = g if best is None else min(best, g)
    return max(gap, best)


@dataclasses.dataclass
class Verdict:
    note_gap: float = 0.0        # widest gap of the styled/recon files
    originals_differ: int = 0    # original files not byte-equal
    files: int = 0               # files compared
    flops: float = 0.0           # matmul FLOPs of the reference request


def judge_request(ref: Reference, comp_bytes: Sequence[bytes],
                  style_bytes: Sequence[bytes], comp_names, style_names,
                  out_dir: str, count_flops: bool = False) -> Verdict:
    """Compare the files that one served request wrote under ``out_dir``
    with the reference's."""
    comps = [ingest(b) for b in comp_bytes]
    styles = [ingest(b) for b in style_bytes]
    verdict = Verdict()

    def read(rel):
        path = os.path.join(out_dir, rel)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            return fh.read()

    for i, comp in enumerate(comps):
        want = original_bytes(comp)
        got = read(f"{comp_names[i]}/original/{comp_names[i]}.mid")
        verdict.files += 1
        verdict.originals_differ += int(got != want)
        for j, style in enumerate(styles):
            got = read(f"{comp_names[i]}/original/{style_names[j]}.mid")
            verdict.files += 1
            verdict.originals_differ += int(got != original_bytes(style))

    if count_flops:
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
    else:
        counter = contextlib.nullcontext()
    with counter:
        latents, Rs, Cb = ref.extract(comps + styles)
        jobs = plan(comp_names, style_names, comps, styles, Rs)
        outs = ref.apply(latents, jobs, Cb)
    if count_flops:
        verdict.flops = float(counter.get_total_flops())
    for job, out in zip(jobs, outs):
        served = read(job.name)
        verdict.files += 1
        if served is None:
            verdict.note_gap = max(verdict.note_gap, UNEXPLAINED)
            continue

        def redo(cats, job=job):
            over = torch.full((1, Cb), -1, dtype=torch.int64)
            over[0, :len(cats)] = torch.tensor(cats)
            return ref.apply(latents, [job], Cb, picked_override=over)[0]

        verdict.note_gap = max(verdict.note_gap,
                               judge_job(served, job, out, redo))
    return verdict


def write_request(outs_by_job, jobs, comps, styles, comp_names, style_names,
                  out_dir: str) -> None:
    """Write a request's files from reference outputs, as the served path
    lays them out: the control puts the reference in the program's
    place this way."""
    def write(rel, data):
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(data)

    for i, comp in enumerate(comps):
        write(f"{comp_names[i]}/original/{comp_names[i]}.mid",
              original_bytes(comp))
        for j, style in enumerate(styles):
            write(f"{comp_names[i]}/original/{style_names[j]}.mid",
                  original_bytes(style))
    for job, out in zip(jobs, outs_by_job):
        bpm = int(torch.round(torch.tensor(out.bpm, dtype=torch.float32)))
        minor = bool(np.argmax(out.mode_logits) == 1)
        write(job.name, job_bytes(decided_info(job.info, bpm, minor), out,
                                  job.n_bars, out.picked, out.has_unpitched))
