"""The record pool's re-pack (mst_torch.transfer.run_fused_jobs): where a
request's records fit its capacity tier but not its pool tier, the
``repack`` program packs the records that the run left on the device again
at the exact tier (``_pooled_buffer``), and the whole program does not run
again.

On the CPU, with ``POOL_TIERS`` and the bundle's pool hints made small
(tiers 16 and 256): a request through the one-program path, the two-program path and
the dense compaction runs its program once and the re-pack once, writes the
files of a bundle whose hints already fit and of the per-job row layout
byte for byte, and leaves the hints of a bundle that needed no re-pack,
which are mst_tpu's; the re-pack's buffer is bit-equal to a whole run's at
the exact tier, after either compaction; ``replay_log_flops`` counts 0
matmul FLOPs for it; the benchmark's ``repacks.serve`` reads nothing from
units that hold no such counter.

On the card (the ``card`` fixture skips without one; JAX is imported only
inside the test that compares with mst_tpu, so ``python3 -m pytest
--noconftest -q tests/test_torch_pool_repack.py -k card`` runs there): the
captured re-pack, bit-equal to the captured whole run at that tier, and a
captured request's files against the per-job row layout's.

Songs: two of 12 bars from ``benchmark.gen.songs`` (a 16-bar bucket, added
to ``BAR_BUCKETS`` here); the weights are the committed ``snapshots/4900``
export.
"""

import os

import pytest
import torch

from mst_torch import transfer as tt
from mst_torch.data.taxonomy import PERCUSSION_ID
from mst_torch.runtime import flops
from mst_torch.runtime import profile as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STARVED = (16, 256) + tt.POOL_TIERS    # the families' exact tiers differ


@pytest.fixture(scope="module")
def song_paths(tmp_path_factory):
    """A composition and a style of 12 bars."""
    from benchmark.gen import songs

    tmp = tmp_path_factory.mktemp("repack_songs")
    size = dict(numer=4, n_bars=12, n_pitched=2, drums=True)
    blobs, _ = songs.make_pool(5, 2, sizes=[size, size])
    paths = [str(tmp / f"{name}.mid") for name in ("comp", "style")]
    for path, blob in zip(paths, blobs):
        with open(path, "wb") as fh:
            fh.write(blob)
    return paths


@pytest.fixture
def small(monkeypatch):
    """A 16-bar bucket and pool tiers of 16 and 256 records."""
    monkeypatch.setattr(tt, "POOL_TIERS", STARVED)
    monkeypatch.setattr(tt, "BAR_BUCKETS", (16,) + tt.BAR_BUCKETS)
    return monkeypatch


def _request(bundle, song_paths, out):
    comp, style = song_paths
    return tt.transfer_style(bundle, comp, [style], str(out))


def _files(paths):
    out = []
    for path in paths:
        with open(path, "rb") as fh:
            out.append((os.path.basename(path), fh.read()))
    return out


def _starved(bundle):
    bundle.pool_hint_p = bundle.pool_hint_u = 1
    return bundle


def _bundle(drums=False, device="cpu", **options):
    """A bundle; ``drums``: the song-info head's percussion logit raised,
    so that the pick takes percussion and the unpitched family has records
    (the trained weights pick none for these songs)."""
    bundle = tt.ModelBundle.from_npz(device=device, **options)
    if drums:
        with torch.no_grad():
            bundle.model.song_info_model.instruments_linear.bias[
                PERCUSSION_ID] = 50.0
    return bundle


PATHS = {
    "one-program": (dict(), ["transfer_fused", "repack"]),
    "two-program": (dict(fuse_requests=False),
                    ["raster_extract", "fused", "repack"]),
    "one-program-drums": (dict(drums=True), ["transfer_fused", "repack"]),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_a_starved_pool_repacks_instead_of_running_again(
        small, song_paths, tmp_path, path):
    options, kinds = PATHS[path]
    starved = _starved(_bundle(**options))
    starved.call_log = log = []
    before = len(tp.units(tt.REQUEST_SPAN))
    written = _request(starved, song_paths, tmp_path / "starved")
    assert len(tp.units(tt.REQUEST_SPAN)) == before + 1
    unit = tp.units(tt.REQUEST_SPAN)[-1]
    assert [k.split(":")[0] for k in starved.programs.runs] == kinds
    assert all(n == 1 for n in starved.programs.runs.values())
    repack_key = list(starved.programs.runs)[-1]
    assert repack_key.startswith("repack:16384:8:pool=")
    assert unit.counters["transfer.repack"] == 1
    assert not any(k.startswith("transfer.redispatch")
                   for k in unit.counters)
    assert flops.replay_log_flops(
        starved, [c for c in log if c[0] == repack_key]) == 0

    fitted = _bundle(**options)
    fitted.pool_hint_p, fitted.pool_hint_u = (starved.pool_hint_p,
                                              starved.pool_hint_u)
    same = _request(fitted, song_paths, tmp_path / "fitted")
    assert not any(k.startswith("repack") for k in fitted.programs.runs)
    rows = _bundle(use_record_pool=False, **options)
    by_rows = _request(rows, song_paths, tmp_path / "rows")
    assert len(written) == 4
    assert _files(written) == _files(same) == _files(by_rows)
    hints = ("capacity_hint", "pool_hint_p", "pool_hint_u")
    assert [getattr(starved, h) for h in hints] == \
        [getattr(fitted, h) for h in hints]
    assert starved.pool_hint_p > 16
    assert (starved.pool_hint_u > 16) == options.get("drums", False)


def test_the_dense_compaction_repacks_too(small, song_paths, tmp_path):
    """A routing table that overflows sends the ladder to the dense
    compaction; its records, too, are packed again, not run again."""
    small.setattr(tt, "COMPACT_CAPACITIES", (16384,))
    small.setattr(tt, "_block_capacities", lambda c: (1, 1))
    starved = _starved(_bundle(drums=True))
    written = _request(starved, song_paths, tmp_path / "dense")
    unit = tp.units(tt.REQUEST_SPAN)[-1]
    runs = list(starved.programs.runs)
    assert runs[:2] == ["transfer_fused:16384:8:pool=16,16",
                        "transfer_fused:16384:8:dense:pool=16,16"]
    assert [k.split(":")[0] for k in runs] == ["transfer_fused"] * 2 + [
        "repack"]
    assert unit.counters["transfer.redispatch.dense"] == 1
    assert unit.counters["transfer.repack"] == 1
    rows = _bundle(drums=True, use_record_pool=False)
    small.undo()          # the rows take the block-routed compaction
    small.setattr(tt, "BAR_BUCKETS", (16,) + tt.BAR_BUCKETS)
    assert _files(written) == _files(_request(rows, song_paths,
                                              tmp_path / "rows"))


def _jobs(bundle, song_paths):
    """The extraction inputs of both songs and the rows of two jobs: the
    composition reconstructed and in the style's style."""
    songs = [tt.get_model_input(p)[1] for p in song_paths]
    (inputs,), statics, Rs = tt._extract_shards(
        bundle, songs, songs[0].info.n_beats, True)
    rows = (torch.tensor([0, 1]), torch.tensor([0, 0]),
            torch.tensor([len(songs[0].instruments),
                          len(songs[1].instruments)]),
            torch.tensor([Rs[0], Rs[0]]),
            torch.tensor([float(songs[0].info.ticks_per_beat)] * 2))
    return inputs, statics, rows


def _run_and_repack(bundle, song_paths, dense):
    """(the re-pack's buffer, a whole run's at the exact tier, the
    ``_pooled_buffer`` of the starved run's records at that tier, the
    starved run's buffer), the starved run at pool tier 16."""
    inputs, statics, rows = _jobs(bundle, song_paths)

    def whole(pool):
        return bundle.fn(tt._program_key("transfer_fused", 16384, 8, dense,
                                         pool))(*inputs, *rows, **statics)

    buf, kept = whole((16, 16))
    head = kept[0].cpu()
    exact = tuple(tt._pick_pool_tier(int(head[:, i].sum()))
                  for i in (4, 5))
    repacked = bundle.fn(tt._program_key("repack", 16384, 8, False,
                                         exact))(*kept)
    full, _ = whole(exact)
    return repacked, full, tt._pooled_buffer(*kept, pool=exact), buf


@pytest.mark.parametrize("dense", [False, True],
                         ids=["block-routed", "dense"])
def test_repack_equals_a_whole_run_at_the_exact_tier(small, song_paths,
                                                     dense):
    bundle = _bundle(drums=True)
    repacked, full, pooled, starved = _run_and_repack(bundle, song_paths,
                                                      dense)
    n_head = 2 * (8 + 8)
    sums = full[:n_head].view(2, 8 + 8)[:, 4:6].sum(0)
    assert (sums > 16).all()           # both families outgrew tier 16
    assert repacked.dtype == full.dtype == torch.int64
    assert torch.equal(repacked, full)
    assert torch.equal(pooled, full)
    # the starved buffer's headers are the exact one's; its pool is cut
    assert torch.equal(starved[:n_head], full[:n_head])
    assert starved.shape == (n_head + 16 * 2 + 16 * 2,)


def test_hints_after_a_repack_match_mst_tpu(small, song_paths, tmp_path):
    """mst_tpu runs its program again at the exact tier; the port packs
    its records again; both leave the same capacity and pool tiers."""
    from mst_tpu import transfer as jt
    from mst_tpu.models import StyleTransferModel as JModel
    from mst_torch import weights
    from tests.test_torch_transfer import _nest

    small.setattr(jt, "POOL_TIERS", STARVED)
    small.setattr(jt, "BAR_BUCKETS", (16,) + jt.BAR_BUCKETS)
    j_bundle = jt.ModelBundle(model=JModel(),
                              params={"params": _nest(weights.load_npz())})
    j_bundle.pool_hint_p = j_bundle.pool_hint_u = 1
    comp, style = song_paths
    jt.transfer_styles(j_bundle, [comp], [style], str(tmp_path / "jax"))
    t_bundle = _starved(tt.ModelBundle.from_npz(device="cpu"))
    tt.transfer_styles(t_bundle, [comp], [style], str(tmp_path / "torch"))
    assert t_bundle.capacity_hint == j_bundle.capacity_hint
    for got, want in ((t_bundle.pool_hint_p, j_bundle.pool_hint_p),
                      (t_bundle.pool_hint_u, j_bundle.pool_hint_u)):
        assert tt._pick_pool_tier(got) == jt._pick_pool_tier(want)
    j_keys = [k for k in j_bundle._jitted if k.startswith("transfer_fused")]
    assert len(j_keys) == 2
    assert [k for k in t_bundle.programs.runs] == [
        j_keys[0], j_keys[1].replace("transfer_fused", "repack")]


def test_the_repacks_reader_reads_nothing_without_the_counter():
    """Units that hold no ``transfer.repack`` (a program without the
    re-pack) read None; units that hold it at 0 read 0."""
    from benchmark import harness

    read = harness.load_module(
        os.path.join(ROOT, "benchmark", "metrics", "repacks.serve.py"),
        "repacks.serve").read
    for _ in range(3):
        with tp.span(tt.REQUEST_SPAN):
            tp.count("transfer.redispatch.pool")
    assert read({"window_units": 3}) is None
    for _ in range(3):
        with tp.span(tt.REQUEST_SPAN):
            tp.count("transfer.repack", 0)
    assert read({"window_units": 3}) == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mst_torch.device import strict_fp32
    strict_fp32()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dense", [False, True],
                         ids=["block-routed", "dense"])
def test_captured_repack_on_the_card(card, small, song_paths, tmp_path,
                                     dense):
    bundle = _bundle(drums=True, device=card)
    assert bundle.capture
    for _ in range(2):        # the capture, then a replay
        repacked, full, pooled, _ = _run_and_repack(bundle, song_paths,
                                                    dense)
        assert torch.equal(repacked, full)
        assert torch.equal(pooled, full)
    kinds = sorted(g.key.split(":")[0]
                   for g in bundle.programs.graphs.values())
    assert kinds == ["repack", "transfer_fused", "transfer_fused"]
    starved = _starved(_bundle(drums=True, device=card))
    written = _request(starved, song_paths, tmp_path / "starved")
    assert [k.split(":")[0] for k in starved.programs.runs] == [
        "transfer_fused", "repack"]
    rows = _bundle(drums=True, device=card, use_record_pool=False)
    assert _files(written) == _files(_request(rows, song_paths,
                                              tmp_path / "rows"))
