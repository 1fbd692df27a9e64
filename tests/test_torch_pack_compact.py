"""K6, the served request's packing and compaction kernel
(mst_torch.ops.compact_kernel), and the dispatch of
``transfer._fused_transfer_apply`` that sends the serving programs to it.

K6's plain version is the composition it replaces,
``_compact_song(_pack_word(...))``. On the CPU the wrapper's card route
runs with plain passes in its place (``_count_blocks``, ``_write_records``:
words from ``_pack_word``, each block's notes counted, the routed blocks'
records scattered), so that its glue (``route_blocks``, the records'
starts, the overflow) is held to the composition bit for bit, in both
note families: a grid of whole 128-cell blocks and one of a ragged last
block, masked channels and bars and a job with no notes, a routing table
that overflows and a count above the capacity, and the hard-output gates
at their edges (a velocity at 0.01, one whose byte truncates to 0, tied
accidentals, accidentals at and under 0.1, a NaN, a duration above 65,535
ticks and a negative one); two launches counted, the composition's FLOPs,
no op that waits for the host; ``takes_kernel``'s decision (every card
tensor, and a bf16 one raises in the wrapper); a served program's buffer
on the card's route and on the composition's, bit-equal, with the dense
compaction taking the composition; the wrapper's input checks; the counter
and the trace category registered.

On the card (the ``card`` fixture skips without one; this file imports no
JAX, so it runs there with ``python3 -m pytest --noconftest
tests/test_torch_pack_compact.py -k card``): K6 against the composition at
the 12-job request's shape (12, 8, 128, 4, 10, 56, 5) and its unpitched
twin, at the 16,384 and 65,536 tiers and with an overflowed routing table
and capacity, bit for bit; the gates at their edges; a CUDA graph's
replay; two launches a call; a request's files on K6 and on the
composition, byte for byte.
"""

import functools
import math
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mst_torch import transfer as tt
from mst_torch.data.taxonomy import PERCUSSION_ID
from mst_torch.ops import compact_kernel as ck
from mst_torch.runtime import flops, profile, programs

FAMILIES = {"pitched": (56, 5), "unpitched": (47, 2)}


def _composition(x, tpb, n_channels, n_bars, capacity, max_blocks):
    """What K6 replaces."""
    word = tt._pack_word(x, tpb.reshape((-1,) + (1,) * 5))
    return tt._compact_song(word, n_channels, n_bars, capacity, max_blocks)


def _valid_words(x, tpb, n_channels, n_bars):
    """``_pack_word``'s words with the cells of channels >= n_channels[b]
    and bars >= n_bars[b] at 0, flat per job and padded to whole blocks:
    (B, G, 128)."""
    B, C, R = x.shape[:3]
    word = tt._pack_word(x, tpb.reshape((-1,) + (1,) * 5))
    ok = ((torch.arange(C)[None] < n_channels[:, None])[:, :, None]
          & (torch.arange(R)[None] < n_bars[:, None])[:, None])
    word = torch.where(ok.reshape(B, C, R, 1, 1, 1), word, 0).reshape(B, -1)
    M = word.shape[1]
    return torch.nn.functional.pad(word, (0, -M % ck.BLOCK)).view(
        B, -1, ck.BLOCK)


def _count_blocks(x, tpb, n_channels, n_bars):
    """Pass 1 in plain torch: the notes of each block, (B, G) int32."""
    return (_valid_words(x, tpb, n_channels, n_bars) != 0).sum(
        -1, dtype=torch.int32)


def _write_records(x, tpb, n_channels, n_bars, routed, incl, capacity):
    """Pass 2 in plain torch: each note of a routed block at its block's
    start plus its rank in the block, below ``capacity``."""
    words = _valid_words(x, tpb, n_channels, n_bars)
    B, G = routed.shape
    note = (words != 0) & (routed > 0)[..., None]
    rank = (incl - routed)[..., None] + note.cumsum(-1) - 1
    slot = torch.where(note & (rank < capacity), rank, capacity).view(B, -1)
    rec = torch.zeros(B, capacity + 1, 2, dtype=torch.int64)
    rec[..., 0].scatter_(1, slot, torch.arange(G * ck.BLOCK).expand(B, -1))
    rec[..., 1].scatter_(1, slot, words.view(B, -1))
    return rec[:, :capacity].contiguous()


@pytest.fixture
def card_route(monkeypatch):
    """The wrapper's card route on the CPU: K6's passes replaced by the
    plain ones, each call counted as the launch would be."""
    monkeypatch.setattr(ck, "_is_card", lambda x: True)
    wrapper = ck.pack_compact

    def counted(plain):
        def run(*args):
            wrapper.launches += 1
            return plain(*args)
        return run

    monkeypatch.setattr(ck, "count_blocks", counted(_count_blocks))
    monkeypatch.setattr(ck, "write_records", counted(_write_records))
    return monkeypatch


def _assert_same(got, want):
    for g, w, name in zip(got, want, ("count", "n_live", "records")):
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert torch.equal(g, w), name


def _applier_like(shape, family, density, seed, device="cpu"):
    """An applier output of ``shape`` (B, C, R, T): velocities above the
    0.01 gate at ``density`` of the cells and under it elsewhere,
    durations up to 6 beats, and accidentals with ties and values at 0.1;
    made on the CPU from ``seed``."""
    N, F = FAMILIES[family]
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(*shape, 10, N, F, generator=g)
    x[..., 0] *= 6.0
    on = torch.rand(x.shape[:-1], generator=g) < density
    x[..., 1] = torch.where(on, x[..., 1], x[..., 1] * 0.0099)
    if F == 5:
        acc = x[..., 2:]
        tie = torch.rand(x.shape[:-1], generator=g) < 0.1
        acc[..., 1][tie] = acc[..., 0][tie]
        acc[torch.rand(x.shape[:-1], generator=g) < 0.1] = 0.1
    return x.to(device)


def _edges(family):
    """One job of hard-output edges, a cell each along the notes of one
    (c, r, t, f) row: (1, 1, 1, 1, 10, N, F) with ``tpb`` 1000."""
    N, F = FAMILIES[family]
    x = torch.zeros(1, 1, 1, 1, 10, N, F)
    f32 = torch.tensor(0.01, dtype=torch.float32)
    rows = [
        # (duration, velocity, accidentals)
        (1.0, 0.01, (0.5, 0.2, 0.2)),                   # at the gate
        (1.0, torch.nextafter(f32, torch.tensor(1.0)).item(),
         (0.5, 0.2, 0.2)),                              # just above it
        (1.0, 0.0078, (0.5, 0.2, 0.2)),                 # byte 0 (gated)
        (1.0, 0.5, (0.7, 0.7, 0.2)),                    # flat ties natural
        (1.0, 0.5, (0.2, 0.7, 0.7)),                    # natural ties sharp
        (1.0, 0.5, (0.7, 0.2, 0.7)),                    # flat ties sharp
        (1.0, 0.5, (0.7, 0.7, 0.7)),                    # all tie
        (1.0, 0.5, (0.1, 0.1, 0.1)),                    # all at 0.1
        (1.0, 0.5, (0.05, 0.1, 0.02)),                  # all <= 0.1
        (1.0, 0.5, (0.05, 0.3, math.nan)),              # a NaN
        (1.0, math.nan, (0.5, 0.2, 0.2)),               # a NaN velocity
        (1.0, 0.5, (0.2, 0.2, 0.9)),                    # sharp alone
        (70.0, 0.5, (0.5, 0.2, 0.2)),                   # 70,000 ticks
        (65.5355, 1.0, (0.5, 0.2, 0.2)),                # 65,535.5 ticks
        (-1.0, 0.5, (0.5, 0.2, 0.2)),                   # a negative one
        (0.0004, 0.999, (0.2, 0.5, 0.2)),               # 0 ticks
    ]
    for n, (d, v, acc) in enumerate(rows):
        x[0, 0, 0, 0, n % 10, n // 10, 0] = d
        x[0, 0, 0, 0, n % 10, n // 10, 1] = v
        if F == 5:
            x[0, 0, 0, 0, n % 10, n // 10, 2:] = torch.tensor(acc)
    return x, torch.tensor([1000.0])


# (B, C, R, T), n_channels, n_bars, capacity, max_blocks, note density
CASES = {
    "whole-blocks": ((2, 2, 8, 4), (2, 1), (8, 5), 16384, 16384, 0.05),
    "ragged": ((3, 2, 5, 3), (2, 1, 2), (5, 3, 5), 16384, 16384, 0.05),
    "masked": ((3, 3, 6, 2), (2, 3, 0), (4, 1, 6), 16384, 16384, 0.05),
    "no-notes": ((2, 2, 3, 2), (2, 2), (3, 3), 16384, 16384, 0.0),
    "overflow": ((3, 2, 5, 3), (2, 2, 1), (5, 4, 5), 10, 3, 0.05),
}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("case", list(CASES))
def test_twin_is_the_composition(card_route, case, family):
    """The card route's glue around the plain passes: the composition's
    results bit for bit."""
    shape, n_ch, n_bars, capacity, max_blocks, density = CASES[case]
    x = _applier_like(shape, family, density, seed=len(case))
    B = shape[0]
    if case == "no-notes":
        x[1, ..., 1] = 0.0                  # job 1: not even under the gate
    tpb = torch.tensor([480.0, 96.0, 1024.0])[:B]
    args = (x, tpb, torch.tensor(n_ch), torch.tensor(n_bars), capacity,
            max_blocks)
    want = _composition(*args)
    _assert_same(ck.pack_compact(*args), want)
    M = x[0, ..., 0].numel()
    count, n_live, _ = want
    if case == "whole-blocks":
        assert M % ck.BLOCK == 0
    if case == "ragged":
        assert M % ck.BLOCK != 0
    if case == "no-notes":
        assert count.tolist() == [0, 0]
    else:
        assert count.min() > 0 or case == "masked"
    if case == "overflow":
        assert (n_live > max_blocks).all()
        assert (count > capacity).any()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gates_at_their_edges(card_route, family):
    """Each gate of the hard output at its edge, a cell each: the words
    the composition forms, and the card route's records are its."""
    x, tpb = _edges(family)
    want_word = tt._pack_word(x, tpb.reshape(1, 1, 1, 1, 1, 1))
    notes = int((want_word != 0).sum())
    assert notes == 13
    if family == "pitched":
        codes = (want_word[0, 0, 0, 0] & 0xFF).T.reshape(-1)[:16].tolist()
        assert codes[3:10] == [0, 1, 0, 0, 1, 1, 1]
        assert codes[11] == 2
    durs = (want_word[0, 0, 0, 0] >> 16).T.reshape(-1)[:16].tolist()
    assert durs[12:] == [65535, 65535, 0, 0]
    args = (x, tpb, torch.tensor([1]), torch.tensor([1]), 16, 2)
    _assert_same(ck.pack_compact(*args), _composition(*args))


class _HostRoundTrips(TorchDispatchMode):
    """Records the ops that wait for a value on the host or copy a host
    tensor in (tests/test_torch_fused.py's check): a capture refuses
    them."""

    WAITS = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket) in self.WAITS:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_card_route_counts_and_waits_for_nothing(card_route, family):
    """The card route's glue between the passes: the composition's
    results, two launches, the composition's block-product FLOPs, and no
    op that waits for the host."""
    shape, n_ch, n_bars, capacity, max_blocks, density = CASES["overflow"]
    x = _applier_like(shape, family, density, seed=5)
    args = (x, torch.tensor([480.0, 96.0, 1024.0]), torch.tensor(n_ch),
            torch.tensor(n_bars), capacity, max_blocks)
    with torch.inference_mode():
        want = _composition(*args)
        want_flops = flops.count_matmul_flops(_composition, *args)
        before = ck.pack_compact.launches
        mode = _HostRoundTrips()
        with mode:
            got = ck.pack_compact(*args)
        assert mode.found == []
        assert ck.pack_compact.launches == before + 2
        got_flops = flops.count_matmul_flops(ck.pack_compact, *args)
    _assert_same(got, want)
    assert got_flops == want_flops > 0


@pytest.mark.parametrize("case,want", [
    ("cpu", False),
    ("card", True),
    ("card-grad", True),
    ("card-grad-disabled", True),
    ("card-bf16", True),
])
def test_takes_kernel(monkeypatch, case, want):
    """K6 takes every applier output on a card, whatever the grad mode;
    the CPU takes the composition. A bf16 output reaches K6's wrapper and
    raises there, rather than running the composition on the card."""
    if case.startswith("card"):
        monkeypatch.setattr(ck, "_is_card", lambda x: True)
    x = torch.zeros(1, 1, 1, 1, 10, 56, 5,
                    dtype=torch.bfloat16 if case == "card-bf16" else
                    torch.float32)
    x.requires_grad_(case.startswith("card-grad"))
    with torch.set_grad_enabled(case == "card-grad"):
        assert ck.takes_kernel(x) is want
    if case == "card-bf16":
        with pytest.raises(ValueError, match="float32"):
            ck.pack_compact(x, torch.ones(1), torch.ones(1), torch.ones(1),
                            16, 4)


@pytest.fixture(scope="module")
def song_paths(tmp_path_factory):
    """A composition and a style of 12 bars with percussion."""
    from benchmark.gen import songs

    tmp = tmp_path_factory.mktemp("k6_songs")
    size = dict(numer=4, n_bars=12, n_pitched=2, drums=True)
    blobs, _ = songs.make_pool(5, 2, sizes=[size, size])
    paths = [str(tmp / f"{name}.mid") for name in ("comp", "style")]
    for path, blob in zip(paths, blobs):
        with open(path, "wb") as fh:
            fh.write(blob)
    return paths


def _served(device="cpu"):
    """The committed weights with percussion picked, so that both note
    families have records."""
    bundle = tt.ModelBundle.from_npz(device=device)
    with torch.no_grad():
        bundle.model.song_info_model.instruments_linear.bias[
            PERCUSSION_ID] = 50.0
    return bundle


def _program(bundle, song_paths, dense):
    """The ``transfer_fused`` program's pooled buffer for two jobs of the
    songs (the composition reconstructed and in the style's style)."""
    songs = [tt.get_model_input(p)[1] for p in song_paths]
    (inputs,), statics, Rs = tt._extract_shards(
        bundle, songs, songs[0].info.n_beats, True)
    rows = (torch.tensor([0, 1]), torch.tensor([0, 0]),
            torch.tensor([len(s.instruments) for s in songs]),
            torch.tensor([Rs[0], Rs[0]]),
            torch.tensor([float(songs[0].info.ticks_per_beat)] * 2))
    key = tt._program_key("transfer_fused", 16384, 8, dense, (4096, 1024))
    buf, _ = bundle.fn(key)(*inputs, *rows, **statics)
    return buf


def test_served_program_routes_agree(song_paths, card_route):
    """A served program on the card's route (K6's passes as the plain
    ones) writes the composition's buffer bit for bit, with K6 called
    once a note family; the dense compaction takes the composition."""
    card_route.setattr(tt, "BAR_BUCKETS", (16,) + tt.BAR_BUCKETS)
    card_route.setattr(ck, "_is_card", lambda x: False)
    bundle = _served()
    want = _program(bundle, song_paths, dense=False)
    want_dense = _program(bundle, song_paths, dense=True)
    calls = []
    wrapper = ck.pack_compact

    def recorded(*args):
        calls.append(args[0].shape[-1])
        return wrapper(*args)

    card_route.setattr(ck, "_is_card", lambda x: True)
    card_route.setattr(ck, "pack_compact", recorded)
    got = _program(bundle, song_paths, dense=False)
    assert calls == [5, 2]
    assert torch.equal(got, want)
    head = got[:2 * 16].view(2, 16)
    assert (head[:, 4] > 0).all() and (head[:, 5] > 0).all()
    assert torch.equal(_program(bundle, song_paths, dense=True), want_dense)
    assert calls == [5, 2]


@pytest.mark.parametrize("case", ["rank", "width", "dtype", "tpb shape",
                                  "capacity", "cpu"])
def test_wrapper_checks_its_inputs(card_route, case):
    """Each input K6 does not take raises, a CPU tensor included (its
    checks run on the card route but for the last case)."""
    x = torch.zeros(2, 1, 2, 1, 10, 56, 5)
    tpb, n_ch, n_bars = torch.ones(2), torch.ones(2), torch.ones(2)
    capacity = 16
    if case == "rank":
        x = x[0]
    elif case == "width":
        x = torch.zeros(2, 1, 2, 1, 10, 47, 5)
    elif case == "dtype":
        x = x.double()
    elif case == "tpb shape":
        tpb = torch.ones(3)
    elif case == "capacity":
        capacity = 0
    else:
        card_route.setattr(ck, "_is_card", lambda x: x.is_cuda)
    with pytest.raises(ValueError, match="pack_compact"):
        ck.pack_compact(x, tpb, n_ch, n_bars, capacity, 4)


def test_counter_and_trace_category_are_registered():
    """A replay adds K6's recorded launches to its counter; a trace files
    both passes under K6."""
    assert (ck.pack_compact, "launches") in programs.COUNTERS
    for name in ("void (anonymous namespace)::pack_compact_count_kernel"
                 "<5>(float const*, float const*)",
                 "void (anonymous namespace)::pack_compact_write_kernel"
                 "<2>(float const*, float const*)"):
        assert profile._kernel_category(name, "kernel", []) == "K6"


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# the 12-job request of 3 x 3 smoke-sized songs: 2-3 channels and 69-124
# bars a job (tools/compaction_torch.py's), one job with 8 times the notes
N_CHANNELS = (3, 2, 2, 3, 2, 3, 2, 2, 3, 2, 3, 2)
N_BARS = (124, 69, 100, 124, 90, 110, 69, 100, 124, 90, 110, 69)
REQUEST = (12, 8, 128, 4)


@functools.cache
def _request_inputs(family, device):
    """The 12-job request's applier output of ``family`` on ``device``,
    notes at 0.15% of the cells and at 1.2% in job 3, and its rows."""
    x = _applier_like(REQUEST if family == "pitched" else
                      (12, 1) + REQUEST[2:], family, 0.0015, seed=1)
    x[3, ..., 1] = torch.where(torch.rand(x[3, ..., 1].shape) < 0.012,
                               x[3, ..., 1] + 0.5, x[3, ..., 1])
    n_ch = torch.tensor(N_CHANNELS if family == "pitched" else (1,) * 12)
    return (x.to(device), torch.full((12,), 480.0, device=device),
            n_ch.to(device), torch.tensor(N_BARS).to(device))


# (pitched capacity, unpitched capacity, routing table of each family) at
# two tiers, and a routing table and a capacity that overflow
TIERS = {"16384": (16384, 4096, tt._block_capacities(16384)),
         "65536": (65536, 16384, tt._block_capacities(65536)),
         "overflow": (48, 48, (64, 64))}


@pytest.mark.card
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("tier", list(TIERS))
def test_k6_is_the_composition_on_the_card(card, tier, family):
    f = family == "unpitched"
    capacity, max_blocks = TIERS[tier][f], TIERS[tier][2][f]
    args = _request_inputs(family, card) + (capacity, max_blocks)
    before = ck.pack_compact.launches
    with torch.inference_mode():
        got = ck.pack_compact(*args)
        want = _composition(*args)
    torch.cuda.synchronize()
    assert ck.pack_compact.launches == before + 2
    _assert_same(got, want)
    count, n_live, _ = want
    assert count.min() > 0
    if tier == "overflow":
        assert (n_live > max_blocks).any() and (count > capacity).any()


@pytest.mark.card
@pytest.mark.parametrize("family", list(FAMILIES))
def test_k6_gates_at_their_edges_on_the_card(card, family):
    x, tpb = _edges(family)
    args = (x.to(card), tpb.to(card), torch.tensor([1], device=card),
            torch.tensor([1], device=card), 16, 2)
    with torch.inference_mode():
        got = ck.pack_compact(*args)
        want = _composition(*args)
    _assert_same(got, want)
    assert int(want[1]) == 4                # 4 live blocks, 2 routed


@pytest.mark.card
def test_k6_replays_in_a_graph(card):
    args = _request_inputs("pitched", card) + (16384, 16384)
    with torch.inference_mode():
        eager = ck.pack_compact(*args)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            ck.pack_compact(*args)                  # warm-up off the graph
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = ck.pack_compact.launches
        with torch.cuda.graph(graph):
            captured = ck.pack_compact(*args)
        assert ck.pack_compact.launches == before + 2
        graph.replay()
        torch.cuda.synchronize()
    _assert_same(captured, eager)


@pytest.mark.card
def test_request_files_are_the_compositions_on_the_card(card, song_paths,
                                                        tmp_path,
                                                        monkeypatch):
    """A captured request's files on K6 and, with K6 turned away, on the
    composition: byte for byte."""
    monkeypatch.setattr(tt, "BAR_BUCKETS", (16,) + tt.BAR_BUCKETS)
    comp, style = song_paths
    outputs = []
    for use_k6 in (True, False):
        if not use_k6:
            monkeypatch.setattr(ck, "takes_kernel", lambda x: False)
        before = ck.pack_compact.launches
        written = tt.transfer_style(_served(card), comp, [style],
                                    str(tmp_path / str(use_k6)))
        assert (ck.pack_compact.launches > before) == use_k6
        files = []
        for path in written:
            with open(path, "rb") as fh:
                files.append((os.path.basename(path), fh.read()))
        outputs.append(files)
    assert len(outputs[0]) == 4
    assert outputs[0] == outputs[1]
