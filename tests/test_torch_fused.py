"""The port's static-shape serving programs against mst_tpu's, on the CPU.

- The compactions and the record pool (``_compact_song`` at the 16,384
  and the chunked 65,536 tier, with the routing table in range and
  overflowed, ``_compact_song_dense``, ``_pack_pool``) against mst_tpu's
  on random packed words (tests/test_transfer.py:190-217): counts,
  live-block counts and records bit-equal.
- The ``fused:`` program's buffer on the same latents (mst_tpu's
  extraction of two synthetic songs) and job rows, in the per-job and the
  pool layout: bpm, mode, n_picked, has_unpitched and picked exact; the
  records under the fp32-boundary rule (``_record_differences``), with the
  counts apart only by the boundary cells, which are listed.
- ``unpack_job_records`` against mst_tpu's on the same buffer.
- The ladder's contracts, as mst_tpu's tests state them
  (tests/test_transfer.py:117-188,405-460), with the same monkeypatching:
  the overflow raises, an overflowed routing table falls back to the dense
  compaction, the dense fallback checks its true counts, the record pool
  gives the per-job layout's files, and the one-program request gives the
  two-program request's files.
- A request leaves the bundle mst_tpu's hints: capacity tier and pool
  tiers.
- The programs' bodies wait for no value on the host and copy no host
  tensor in (what a CUDA graph capture refuses), checked on the CPU with a
  dispatch mode.

Songs come from tools/make_corpus.py (seeds 0 and 235: 2 channels each,
percussion, 39 and 42 bars: one extraction bucket, Rb 64); the weights are
the committed ``snapshots/4900`` export.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mst_tpu import transfer as jt
from mst_tpu.models import StyleTransferModel as JModel
from mst_torch import transfer as tt
from mst_torch import weights
from mst_torch.config import ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import grid_kernel, raster_kernel
from tests.test_torch_model import NARROW
from tests.test_torch_transfer import _nest, _write_songs

C, R, T = 2, 64, 4


@pytest.fixture(scope="module")
def j_bundle():
    return jt.ModelBundle(model=JModel(),
                          params={"params": _nest(weights.load_npz())})


@pytest.fixture(scope="module")
def request_paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("songs")
    return _write_songs(tmp, (0,)), _write_songs(tmp, (235,))


def _words(seed, density=0.1):
    """Random packed words (C, R, T, 10, 56) of the given note density
    (tests/test_transfer.py:199-208)."""
    rng = np.random.default_rng(seed)
    shape = (C, R, T, 10, 56)
    vel = ((rng.random(shape) < density)
           * rng.integers(1, 128, shape)).astype(np.uint8)
    dur = rng.integers(0, 1000, shape).astype(np.uint16)
    acc = rng.integers(0, 3, shape).astype(np.uint8)
    return np.where(vel > 0, (dur.astype(np.uint32) << 16)
                    | (vel.astype(np.uint32) << 8)
                    | acc.astype(np.uint32), 0).astype(np.uint32)


# two jobs: all of both channels and bars, and one channel of 40 bars
JOBS = ((2, 64), (1, 40))


def _batch(words):
    n_ch = torch.tensor([j[0] for j in JOBS])
    n_bars = torch.tensor([j[1] for j in JOBS])
    return (torch.from_numpy(np.stack(words).astype(np.int64)), n_ch,
            n_bars)


@pytest.mark.parametrize("capacity,max_blocks", [
    (16384, 16384), (16384, 700), (65536, 16384), (65536, 700)],
    ids=["16384", "16384-table-overflow", "65536", "65536-table-overflow"])
def test_compact_song_matches_mst_tpu(capacity, max_blocks):
    """~28,700 notes a full job (over 16,384: the records truncate) in
    2,240 blocks; a 700-block routing table overflows, so the count
    under-reports and the live-block count does not."""
    words = [_words(0), _words(1)]
    got_count, got_live, got_rec = tt._compact_song(
        *_batch(words), capacity, max_blocks)
    compact = jax.jit(lambda w, nc, nb: jt._compact_song(
        w, nc, nb, capacity, max_blocks))
    for b, (n_ch, n_bars) in enumerate(JOBS):
        count, live, rec = compact(jnp.asarray(words[b]), n_ch, n_bars)
        assert int(got_count[b]) == int(count)
        assert int(got_live[b]) == int(live)
        np.testing.assert_array_equal(got_rec[b].numpy(),
                                      np.asarray(rec).astype(np.int64))
    assert int(got_live[0]) > max_blocks or max_blocks == 16384
    assert int(got_count[0]) > min(capacity, 16384) or max_blocks == 700


@pytest.mark.parametrize("capacity", [16384, 65536])
def test_compact_song_dense_matches_mst_tpu(capacity):
    words = [_words(2), _words(3)]
    got_count, got_live, got_rec = tt._compact_song_dense(*_batch(words),
                                                          capacity)
    compact = jax.jit(lambda w, nc, nb: jt._compact_song_dense(
        w, nc, nb, capacity))
    for b, (n_ch, n_bars) in enumerate(JOBS):
        count, live, rec = compact(jnp.asarray(words[b]), n_ch, n_bars)
        assert int(got_count[b]) == int(count)
        assert int(got_live[b]) == int(live) == 0
        np.testing.assert_array_equal(got_rec[b].numpy(),
                                      np.asarray(rec).astype(np.int64))


@pytest.mark.parametrize("pool_cap", [8192, 65536],
                         ids=["truncating", "roomy"])
def test_pack_pool_matches_mst_tpu(pool_cap):
    """Three jobs, the middle one empty; the first job's count (~28,700)
    exceeds its 16,384 records."""
    words = [_words(4), np.zeros_like(_words(4)), _words(5, density=0.01)]
    w = torch.from_numpy(np.stack(words).astype(np.int64))
    count, _, rec = tt._compact_song(w, torch.tensor([2, 2, 1]),
                                     torch.tensor([64, 64, 30]), 16384,
                                     16384)
    assert int(count[1]) == 0 and int(count[0]) > 16384
    got = tt._pack_pool(rec, count, pool_cap)
    want = jt._pack_pool(jnp.asarray(rec.numpy().astype(np.uint32)),
                         jnp.asarray(count.numpy().astype(np.uint32)),
                         pool_cap)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def _record_differences(got, want):
    """Job records (n, 2) uint32 of two frameworks under the fp32-boundary
    rule (mst_torch.parity, on records): a cell both hold has the same
    accidental code and a velocity byte and duration tick within 1; a cell
    one side holds alone has a velocity byte <= 2 (the 0.01 gate).
    Returns (faults, boundary cells held by one side)."""
    g = {int(c): int(w) for c, w in got}
    h = {int(c): int(w) for c, w in want}
    assert len(g) == len(got) and len(h) == len(want)   # cells unique
    assert list(g) == sorted(g) and list(h) == sorted(h)

    def fields(word):
        return word >> 16, (word >> 8) & 0xFF, word & 0xFF

    faults, alone = [], []
    for cell in g.keys() & h.keys():
        (dg, vg, ag), (dh, vh, ah) = fields(g[cell]), fields(h[cell])
        if ag != ah or abs(vg - vh) > 1 or abs(dg - dh) > 1:
            faults.append((cell, g[cell], h[cell]))
    for cell in g.keys() ^ h.keys():
        word = g.get(cell, h.get(cell))
        (alone if fields(word)[1] <= 2 else faults).append((cell, word))
    return faults, alone


@pytest.fixture(scope="module")
def fused_case(j_bundle, request_paths):
    """mst_tpu's latents of the two songs and the rows of three jobs:
    song 0 reconstructed, song 0 in song 1's style, song 1 reconstructed."""
    comps, styles = request_paths
    songs = [jt.get_model_input(p)[1] for p in comps + styles]
    batches, _ = jt.extract_styles(j_bundle, songs)
    (batch,) = batches
    latents = [np.asarray(x) for x in (batch.style, batch.melody,
                                       batch.rhythm)]
    style_idx = np.array([0, 1, 1], np.int32)
    comp_idx = np.array([0, 0, 1], np.int32)
    n_inst = np.array([len(songs[s].instruments) for s in style_idx],
                      np.int32)
    bars = np.array([batch.n_bars[c] for c in comp_idx], np.int32)
    tpb = np.array([songs[c].info.ticks_per_beat for c in comp_idx],
                   np.float32)
    return latents, (style_idx, comp_idx, n_inst, bars, tpb)


LAYOUTS = {"rows": None, "pool": (8192, 4096)}


@pytest.fixture(scope="module")
def fused_buffers(j_bundle, fused_case):
    """{layout: (mst_tpu's buffer, the port's buffer)}, uint32, of the
    ``fused:16384:8`` program on the same latents and job rows."""
    latents, rows = fused_case
    t_bundle = tt.ModelBundle.from_npz(device="cpu")
    out = {}
    for name, pool in LAYOUTS.items():
        key = tt._program_key("fused", 16384, 8, False, pool)
        want = j_bundle.fn(key)(j_bundle.params,
                                *(jnp.asarray(x) for x in latents),
                                *(jnp.asarray(r) for r in rows))
        got = t_bundle.fn(key)(
            *(torch.tensor(x) for x in latents),
            *(torch.from_numpy(r.astype(np.int64)) for r in rows[:4]),
            torch.from_numpy(rows[4]))
        if pool is not None:     # the buffer, and the records it packs
            got, _ = got
        out[name] = (np.asarray(want), got.numpy().astype(np.uint32))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fused_buffer_matches_mst_tpu(fused_buffers, layout):
    want, got = fused_buffers[layout]
    pool = LAYOUTS[layout]
    assert got.shape == want.shape and got.dtype == want.dtype
    boundary = []
    views = zip(tt.unpack_job_records(got, 3, 8, 16384, pool),
                jt.unpack_job_records(want, 3, 8, 16384, pool))
    for b, ((g_hdr, g_pick, g_p, g_u), (w_hdr, w_pick, w_p, w_u)) in \
            enumerate(views):
        np.testing.assert_array_equal(g_hdr[:4], w_hdr[:4])
        np.testing.assert_array_equal(g_pick, w_pick)
        assert g_pick.dtype == np.int32 and (g_pick[int(g_hdr[2]):] == -1).all()
        for family, g, w, i in (("pitched", g_p, w_p, 4),
                                ("unpitched", g_u, w_u, 5)):
            faults, alone = _record_differences(g, w)
            assert not faults, (b, family, faults[:5])
            got_cells = set(g[:, 0].tolist())
            got_alone = sum(cell in got_cells for cell, _ in alone)
            assert len(g) - len(w) == got_alone - (len(alone) - got_alone)
            assert int(g_hdr[i]) == len(g) and int(w_hdr[i]) == len(w)
            assert abs(int(g_hdr[i + 2]) - int(w_hdr[i + 2])) <= len(alone)
            boundary += [(b, family, cell, word) for cell, word in alone]
        assert int(g_hdr[4]) > 0
    # the boundary cells, listed (none expected; any is a gate cell)
    print(f"{layout}: boundary cells {boundary}")
    if not boundary:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unpack_job_records_matches_mst_tpu(fused_buffers, layout):
    want, _ = fused_buffers[layout]
    pool = LAYOUTS[layout]
    got_views = tt.unpack_job_records(want, 3, 8, 16384, pool)
    want_views = jt.unpack_job_records(want, 3, 8, 16384, pool)
    assert len(got_views) == len(want_views) == 3
    for g, w in zip(got_views, want_views):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tt._header_table(want, 3, 8, pool).shape == (3, 8)


# -- the ladder's contracts (tests/test_transfer.py:117-188,405-460) -------

@pytest.fixture(scope="module")
def latents(request_paths):
    """The port's latents of song 0 (its style vector, melody, rhythm, real
    bars) and its song."""
    _, song = tt.get_model_input(request_paths[0][0])
    bundle = tt.ModelBundle.from_npz(device="cpu")
    return song, tt.extract_style(bundle, song)


def _dense_bundle():
    """Every cell a note: the appliers' velocity bias at +5."""
    bundle = tt.ModelBundle.from_npz(device="cpu")
    with torch.no_grad():
        for name in ("pitched_style_applier", "unpitched_style_applier"):
            getattr(bundle.model, name).linear.bias[1] = 5.0
    return bundle


def _apply(bundle, latents, path):
    song, (style, melody, rhythm, n_bars) = latents
    tt.apply_style(bundle, song.info, style, melody, rhythm,
                   len(song.instruments), str(path), n_bars=n_bars)


def test_apply_style_overflow_raises(latents, tmp_path, monkeypatch):
    """Counts beyond the largest capacity raise; the written .mid is never
    silently truncated."""
    monkeypatch.setattr(tt, "COMPACT_CAPACITIES", (256,))
    with pytest.raises(OverflowError):
        _apply(_dense_bundle(), latents, tmp_path / "x.mid")


def test_block_table_overflow_falls_back_to_dense_compaction(
        latents, tmp_path, monkeypatch):
    """A routing table that overflows while the records fit falls back to
    the dense compaction and writes the full output."""
    normal = tt.ModelBundle.from_npz(device="cpu")
    _apply(normal, latents, tmp_path / "normal.mid")
    monkeypatch.setattr(tt, "_block_capacities", lambda c: (1, 1))
    starved = tt.ModelBundle.from_npz(device="cpu")
    _apply(starved, latents, tmp_path / "dense.mid")
    assert (tmp_path / "dense.mid").read_bytes() == \
        (tmp_path / "normal.mid").read_bytes()
    assert list(starved.programs.runs) == [
        f"fused:{c}:8:pool=8192,8192" for c in tt.COMPACT_CAPACITIES] + [
        f"fused:{tt.COMPACT_CAPACITIES[-1]}:8:dense:pool=8192,8192"]


def test_dense_fallback_rechecks_true_counts(latents, tmp_path, monkeypatch):
    """An overflowed routing table under-reports the counts (here <= 128,
    which fits 256); the dense fallback's true counts must raise."""
    monkeypatch.setattr(tt, "_block_capacities", lambda c: (1, 1))
    monkeypatch.setattr(tt, "COMPACT_CAPACITIES", (256,))
    bundle = _dense_bundle()
    with pytest.raises(OverflowError):
        _apply(bundle, latents, tmp_path / "x.mid")
    assert any(":dense" in k for k in bundle.programs.runs)


def test_record_pool_matches_per_job_layout(request_paths, tmp_path,
                                            monkeypatch):
    """The pool layout is a transport choice only: the files equal the
    per-job row layout's, also when the first program's pool tier is too
    small and the ladder packs its records again at the exact tier."""
    comps, styles = request_paths
    rows = tt.ModelBundle.from_npz(device="cpu", use_record_pool=False)
    written_rows = tt.transfer_style(rows, comps[0], styles,
                                     tmp_path / "rows")
    pooled = tt.ModelBundle.from_npz(device="cpu")
    pooled.pool_hint_p = pooled.pool_hint_u = 1
    monkeypatch.setattr(tt, "POOL_TIERS", (16,) + tt.POOL_TIERS)
    written_pool = tt.transfer_style(pooled, comps[0], styles,
                                     tmp_path / "pool")
    assert pooled.pool_hint_p > 16
    assert list(pooled.programs.runs) == [
        "transfer_fused:16384:8:pool=16,16",
        "repack:16384:8:pool=8192,8192"]
    assert all(":pool" not in k for k in rows.programs.runs)
    assert len(written_rows) == len(written_pool) == 4
    for a, b in zip(written_rows, written_pool):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_fused_request_matches_two_dispatch_path(request_paths, tmp_path):
    """A request whose songs share one extraction bucket runs as one
    program; its files equal the two-program request's."""
    comps, styles = request_paths
    fused = tt.ModelBundle.from_npz(device="cpu")
    assert fused.fuse_requests
    written_fused = tt.transfer_style(fused, comps[0], styles,
                                      tmp_path / "fused")
    unfused = tt.ModelBundle.from_npz(device="cpu", fuse_requests=False)
    written_plain = tt.transfer_style(unfused, comps[0], styles,
                                      tmp_path / "plain")
    assert set(k.split(":")[0] for k in fused.programs.runs) == {
        "transfer_fused"}
    assert set(k.split(":")[0] for k in unfused.programs.runs) == {
        "raster_extract", "fused"}
    assert len(written_fused) == len(written_plain) == 4
    for a, b in zip(written_fused, written_plain):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_hints_after_a_request_match_mst_tpu(j_bundle, request_paths,
                                             tmp_path):
    comps, styles = request_paths
    j_bundle.capacity_hint = j_bundle.pool_hint_p = j_bundle.pool_hint_u = 0
    jt.transfer_styles(j_bundle, comps, styles, str(tmp_path / "jax"))
    t_bundle = tt.ModelBundle.from_npz(device="cpu")
    tt.transfer_styles(t_bundle, comps, styles, str(tmp_path / "torch"))
    assert t_bundle.capacity_hint == j_bundle.capacity_hint == 16384
    for got, want in ((t_bundle.pool_hint_p, j_bundle.pool_hint_p),
                      (t_bundle.pool_hint_u, j_bundle.pool_hint_u)):
        assert tt._pick_pool_tier(got) == jt._pick_pool_tier(want)
    assert list(t_bundle.programs.runs) == [
        k for k in j_bundle._jitted if k.startswith("transfer_fused")]


class _HostRoundTrips(TorchDispatchMode):
    """Records the ops that wait for a value on the host or copy a host
    tensor in: ``.item()`` and ``bool()`` (``_local_scalar_dense``),
    ``nonzero`` (its size), ``torch.tensor(...)`` (``lift_fresh``).
    ``plain`` > 0 while a kernel's plain version runs: on the card the
    kernel runs there."""

    WAITS = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.found = []
        self.plain = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.plain and str(func.overloadpacket) in self.WAITS:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def test_programs_make_no_host_round_trip(request_paths, monkeypatch):
    """The ``transfer_fused`` program's body and the ``repack`` program's
    on its records, on the CPU at narrow widths, run no op that waits for
    the device or copies a host tensor in (either would synchronise on
    the card, and a capture refuses it); the kernels' plain versions are
    left out."""
    mode = _HostRoundTrips()

    def outside(plain):
        def run(*args, **kwargs):
            mode.plain += 1
            try:
                return plain(*args, **kwargs)
            finally:
                mode.plain -= 1
        return run

    monkeypatch.setattr(raster_kernel, "segment_rasterize_plain",
                        outside(raster_kernel.segment_rasterize_plain))
    monkeypatch.setattr(grid_kernel, "grid_tail_plain",
                        outside(grid_kernel.grid_tail_plain))
    bundle = tt.ModelBundle(model=StyleTransferModel(ModelConfig(**NARROW)),
                            device="cpu")
    comps, styles = request_paths
    songs = [tt.get_model_input(p)[1] for p in comps + styles]
    (inputs,), statics, Rs = tt._extract_shards(bundle, songs, T, True)
    rows = (torch.tensor([0, 1]), torch.tensor([0, 0]), torch.tensor([2, 2]),
            torch.tensor(Rs[:1] * 2), torch.tensor([480.0, 480.0]))
    with mode:
        torch.tensor([1.0])                  # the check sees what it seeks
        assert mode.found == ["aten.lift_fresh.default"]
        mode.found.clear()
        for dense in (False, True):
            buf, kept = bundle.fn(tt._program_key("transfer_fused", 16384, 8,
                                                  dense, (8192, 8192)))(
                *inputs, *rows, **statics)
            repacked = bundle.fn(tt._program_key("repack", 16384, 8, False,
                                                 (16384, 8192)))(*kept)
    assert mode.found == []
    assert buf.shape == (2 * 16 + 2 * 8192 * 2,)
    assert repacked.shape == (2 * 16 + 16384 * 2 + 8192 * 2,)
