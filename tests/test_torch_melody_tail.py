"""K5, the melody encoder's note tail and channel pooling kernel
(mst_torch.ops.melody_kernel), and the dispatch of
``models.encoders.MelodyEncoder`` that sends serving's extraction to it.

On the CPU: the dispatch takes the composition (``melody_tail_plain``)
where autograd records, under the bf16 policies and on the CPU, and K5 on
a card raster at fp32 where no gradient is needed, where a width K5 does
not take raises; the CPU forward is the parent composition's, bit for
bit; K5's algorithm written in plain torch (``_passes``, standing in for
the launch behind the wrapper: the octave and scale-degree embeddings
once a (b, c, r, t), masked channels skipped, the squared norms in a
first pass and the pooled sum in a second, through ``seq_sum``) holds the
fp32-reassociation rule (tests/test_torch_train.py's ``_assert_close``)
against the composition at narrow and published widths and under every
kind of mask; the K5 route counts the composition's FLOPs; the wrapper
runs the plain version for CPU tensors and checks its inputs; the counter
and the trace category are registered.

On the card (the ``card`` fixture skips without one; this file imports no
JAX, so it runs there with ``python3 -m pytest --noconftest
tests/test_torch_melody_tail.py -k card``): K5 against the plain version
at the serving shape (6 songs x 8 channels x 128 bars x 4 beats, 2 or 3
live channels a song) and at an odd-bar shape, under the fp32 rule; the
same bits in three runs and in a CUDA graph's replay; two launches a call;
the encoder's K5 route against its composition.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mst_torch.models.encoders import MelodyEncoder
from mst_torch.models.layers import leaky_relu
from mst_torch.ops import melody_kernel, seq_context
from mst_torch.ops.flop_scope import uncounted
from mst_torch.ops.precision import precision
from mst_torch.ops.shapes import cat_with_broadcast, combine, squash_dims
from mst_torch.runtime import flops, programs, profile

# (beat_size, bar_size) of tests/test_torch_model.py's NARROW and of
# ModelConfig(); melody_size is 8 in both
NARROW = (16, 16)
PUBLISHED = (64, 128)
# (B, Cb) masks: a prefix, a non-prefix, a fully masked song row, none,
# and Cb 8 with 2-3 live channels (the serving traffic's songs)
MASKS = {
    "prefix": [[1, 1, 0], [1, 0, 0]],
    "non-prefix": [[0, 1, 1], [1, 0, 1]],
    "masked-row": [[1, 1, 1], [0, 0, 0]],
    "none": None,
    "cb8": [[1, 1, 0, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0, 0, 0]],
}


def _assert_close(got, want, label=""):
    """tests/test_fused_tails.py's fp32-reassociation tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 + 2e-6 * np.abs(want).max(),
                               err_msg=label)


def _encoder(widths=NARROW, seed=1):
    enc = MelodyEncoder(8, *widths)
    generator = torch.Generator().manual_seed(seed)
    for module in enc.modules():
        if module is not enc and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return enc


def _inputs(b, cb, r, t, widths=NARROW, mask=None, seed=0, device="cpu"):
    """(beats, bars, channels, instruments, mask): a sparse raster of
    values in [0, 1), as K1 writes, and N(0, 1/4) activations."""
    g = torch.Generator().manual_seed(seed)
    beat, bar = widths
    beats = torch.randn(b, cb, r, t, beat, generator=g) / 2
    bars = torch.randn(b, r, bar, generator=g) / 2
    hit = torch.rand(b, cb, r, t, 10, 56, 5, generator=g) < 0.05
    channels = hit * torch.rand(b, cb, r, t, 10, 56, 5, generator=g)
    instruments = torch.rand(b, cb, 51, generator=g)
    m = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    return tuple(None if x is None else x.to(device)
                 for x in (beats, bars, channels, instruments, m))


def _parent_forward(enc, beats, bars, channels, instruments,
                    channel_mask=None):
    """MelodyEncoder.forward as it was before K5: the composition over the
    repeated fraction axis."""
    m = enc.melody_size
    x1 = leaky_relu(enc.beats_linear(beats))[:, :, :, :, None, :]
    x2 = leaky_relu(enc.bars_linear(bars))[:, None, :, None, None, :]
    x3 = leaky_relu(enc.instruments_linear(instruments))[
        :, :, None, None, None, :]
    y = cat_with_broadcast([
        x1.expand(tuple(x1.shape[:4]) + (10, x1.shape[-1])), x2, x3], -1)
    x = enc.octave_linear(y)
    x = x.reshape(tuple(x.shape[:-1]) + (8, m))
    x1 = leaky_relu(x)[..., :, None, :]
    x = enc.scale_degree_linear(y)
    x = x.reshape(tuple(x.shape[:-1]) + (7, m))
    x2 = leaky_relu(x)[..., None, :, :]
    x1 = squash_dims(leaky_relu(x1 + x2), 5, 7)
    x2 = leaky_relu(enc.channels_linear(channels))
    x = leaky_relu(enc.linear(cat_with_broadcast([x1, x2], -1)))
    return combine(x, axis=1, mask=channel_mask, over_bars=True)


def _passes(o, s, channels, wc, bc, w, b, mask=None):
    """K5's algorithm (csrc/melody_tail.cu's header) in plain torch: the
    tail from one embedding row a (b, c, r, t), live channels only; pass 1
    the squared norm of each, summed over the seq ranks; pass 2 the
    channels' weighted sum in ascending order over the mask's denominator.
    """
    B, Cb, R, T = channels.shape[:4]
    m = w.shape[0]
    weight = torch.ones(B, Cb) if mask is None else mask.float()

    def leaky(x):
        return F.leaky_relu(x, 0.01)

    def tail(i, c):
        z = leaky(o[i, c, :, :, 0].reshape(R, T, 8, 1, m)
                  + s[i, c, :, :, 0].reshape(R, T, 1, 7, m))
        z = z.reshape(R, T, 1, 56, m).expand(R, T, 10, 56, m)
        x = leaky(channels[i, c] @ wc.t() + bc)
        return leaky(torch.cat([z, x], -1) @ w.t() + b)

    live = [(i, c) for i in range(B) for c in range(Cb) if weight[i, c]]
    sq = torch.zeros(B, Cb)
    for i, c in live:
        y = tail(i, c)
        sq[i, c] = (y * y).sum()
    sq = seq_context.seq_sum(sq)
    norm = torch.sqrt(1 + sq) * weight
    denom = norm.sum(dim=1)
    if mask is not None:
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.zeros(B, R, T, 10, 56, m)
    for i, c in live:
        out[i] += (tail(i, c) * weight[i, c]) * norm[i, c]
    return out / denom.reshape(B, 1, 1, 1, 1, 1)


class _Recorder:
    """Stands in for a route of the encoder: records the call and returns
    the composition's result."""

    def __init__(self):
        self.calls = 0

    def __call__(self, o, s, channels, wc, bc, w, b, mask=None, *,
                 embed_width):
        self.calls += 1
        return melody_kernel.melody_tail_plain(o, s, channels, wc, bc, w, b,
                                               mask)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("case,want", [
    ("cpu", "plain"),
    ("card", "kernel"),
    ("card-grad", "plain"),
    ("card-grad-disabled", "kernel"),
    ("card-bf16-storage", "plain"),
    ("card-bf16-compute", "plain"),
    ("card-other-width", "raises"),
])
def test_dispatch(monkeypatch, case, want):
    """K5 on a card raster at fp32 where no gradient is needed; the
    composition where autograd records, under either bf16 policy, and on
    the CPU. A width K5 does not take raises on the card."""
    if case.startswith("card"):
        monkeypatch.setattr(melody_kernel, "_is_card", lambda x: True)
    kernel = _Recorder()
    if case == "card-other-width":
        monkeypatch.setattr(melody_kernel, "WIDTHS", ((16, 11),))
    else:
        monkeypatch.setattr(melody_kernel, "melody_tail", kernel)
    enc = _encoder()
    beats, bars, channels, instruments, mask = _inputs(
        2, 3, 2, 3, mask=MASKS["prefix"])
    policy = {"card-bf16-storage": ("float32", "bfloat16"),
              "card-bf16-compute": ("bfloat16", "float32")}.get(
        case, ("float32", "float32"))
    grad = case == "card-grad"
    enc.requires_grad_(grad or case == "card-grad-disabled")
    with precision(*policy), torch.set_grad_enabled(grad):
        if want == "raises":
            with pytest.raises(ValueError, match=r"melody_tail: \(M, CH\)"):
                enc(beats, bars, channels, instruments, mask)
            return
        enc(beats, bars, channels, instruments, mask)
    assert kernel.calls == (want == "kernel")


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["inference", "grad"])
def test_cpu_forward_is_the_parents(policy, mode):
    """On the CPU the encoder runs the composition it ran before K5, bit
    for bit, under either policy, with autograd on or off."""
    enc = _encoder()
    args = _inputs(2, 3, 2, 3, mask=MASKS["non-prefix"])
    ctx = torch.inference_mode() if mode == "inference" else \
        torch.enable_grad()
    with precision(policy, policy), ctx:
        got = enc(*args)
        want = _parent_forward(enc, *args)
    assert got.dtype == want.dtype
    assert torch.equal(got.detach(), want.detach())


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("widths", [NARROW, PUBLISHED],
                         ids=["narrow", "published"])
def test_pass_algebra_against_the_composition(monkeypatch, widths, mask):
    """K5's algorithm in plain torch, in the encoder's K5 route (one
    embedding row a (b, c, r, t)), holds the fp32 rule against the
    composition: at both widths, under every kind of mask, at an odd bar
    count."""
    enc = _encoder(widths)
    cb = len(MASKS[mask][0]) if MASKS[mask] else 3
    args = _inputs(2, cb, 3, 4, widths, MASKS[mask])
    with torch.inference_mode():
        want = enc(*args)
        monkeypatch.setattr(melody_kernel, "_is_card", lambda x: True)
        monkeypatch.setattr(melody_kernel, "_launch", _passes)
        got = enc(*args)
    assert got.shape == want.shape == (2, 3, 4, 10, 56, 8)
    _assert_close(got, want, f"{widths} {mask}")
    if mask == "masked-row":
        assert not got[1].any()


def test_pass_algebra_sums_the_norms_over_seq_ranks(monkeypatch):
    """Pass 1's squared norms go through ``seq_sum``, as ``combine``'s do:
    with a hook standing in for two seq ranks that hold the same bars
    (each norm doubled), both routes still agree."""
    monkeypatch.setattr(seq_context, "seq_sum", lambda x: 2 * x)
    enc = _encoder()
    args = _inputs(2, 3, 2, 4, mask=MASKS["non-prefix"])
    with torch.inference_mode():
        want = enc(*args)
        monkeypatch.setattr(melody_kernel, "_is_card", lambda x: True)
        monkeypatch.setattr(melody_kernel, "_launch", _passes)
        got = enc(*args)
        monkeypatch.setattr(seq_context, "seq_sum", lambda x: x)
        alone = enc(*args)
    _assert_close(got, want, "seq_sum hook")
    assert not torch.allclose(got, alone)


def test_kernel_route_counts_the_compositions_flops(monkeypatch):
    """The K5 route counts what the composition counts: its two
    embedding products over the 10 fractions (the prologue runs one, the
    wrapper adds the other 9) and the note grid's products of every
    channel, masked ones included (the wrapper's count on the card)."""
    enc = _encoder()
    args = _inputs(2, 3, 2, 4, mask=MASKS["prefix"])

    def kernel(*inputs):
        with uncounted():
            return _passes(*inputs)

    with torch.inference_mode():
        want = flops.count_matmul_flops(enc, *args)
        monkeypatch.setattr(melody_kernel, "_is_card", lambda x: True)
        monkeypatch.setattr(melody_kernel, "_launch", kernel)
        got = flops.count_matmul_flops(enc, *args)
    assert got == want > 0


@pytest.mark.parametrize("mask", ["prefix", "none"])
def test_wrapper_runs_the_plain_version_on_the_cpu(mask):
    g = torch.Generator().manual_seed(4)
    _, _, channels, _, m = _inputs(2, 3, 2, 3, mask=MASKS[mask])
    o = torch.randn(2, 3, 2, 3, 1, 64, generator=g)
    s = torch.randn(2, 3, 2, 3, 1, 56, generator=g)
    weights = (torch.randn(7, 5, generator=g), torch.randn(7, generator=g),
               torch.randn(8, 15, generator=g), torch.randn(8, generator=g))
    with torch.inference_mode():
        got = melody_kernel.melody_tail(o, s, channels, *weights, m,
                                        embed_width=0)
        want = melody_kernel.melody_tail_plain(o, s, channels, *weights, m)
    assert got.shape == (2, 2, 3, 10, 56, 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["o fractions", "s width", "channels rank",
                                  "w shape", "mask shape", "dtype"])
def test_wrapper_checks_its_inputs(case):
    _, _, channels, _, mask = _inputs(2, 3, 2, 3, mask=MASKS["prefix"])
    o = torch.zeros(2, 3, 2, 3, 1, 64)
    s = torch.zeros(2, 3, 2, 3, 1, 56)
    wc, bc, w, b = (torch.zeros(7, 5), torch.zeros(7), torch.zeros(8, 15),
                    torch.zeros(8))
    if case == "o fractions":
        o = torch.zeros(2, 3, 2, 3, 10, 64)
    elif case == "s width":
        s = s[..., :48]
    elif case == "channels rank":
        channels = channels.reshape(2, 3, 2, 3, 10, 280)
    elif case == "w shape":
        w = w[:, :14]
    elif case == "mask shape":
        mask = mask[:, :2]
    else:
        o = o.double()
    with pytest.raises(ValueError, match="melody_tail"):
        melody_kernel.melody_tail(o, s, channels, wc, bc, w, b, mask,
                                  embed_width=0)


def test_counter_and_trace_category_are_registered():
    """A replay adds K5's recorded launches to its counter; a trace files
    both passes under K5."""
    assert (melody_kernel.melody_tail, "launches") in programs.COUNTERS
    for name in ("void (anonymous namespace)::melody_tail_norms_kernel"
                 "<8, 7>(float const*, float const*)",
                 "void (anonymous namespace)::melody_tail_pool_kernel"
                 "<8, 7>(float const*, float const*)"):
        assert profile._kernel_category(name, "kernel", []) == "K5"


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tail_inputs(b, cb, r, t, live, seed, device):
    """The wrapper's inputs at an extraction shape: ``live`` channels of
    each song unmasked (a prefix, as transfer pads them), embeddings of
    the size the model's leaky ReLUs give, weights at the model's init."""
    g = torch.Generator().manual_seed(seed)
    hit = torch.rand(b, cb, r, t, 10, 56, 5, generator=g) < 0.05
    channels = hit * torch.rand(b, cb, r, t, 10, 56, 5, generator=g)
    o = F.leaky_relu(torch.randn(b, cb, r, t, 1, 64, generator=g), 0.01)
    s = F.leaky_relu(torch.randn(b, cb, r, t, 1, 56, generator=g), 0.01)
    wc = (torch.rand(7, 5, generator=g) * 2 - 1) / 5 ** 0.5
    bc = (torch.rand(7, generator=g) * 2 - 1) / 5 ** 0.5
    w = (torch.rand(8, 15, generator=g) * 2 - 1) / 15 ** 0.5
    bias = (torch.rand(8, generator=g) * 2 - 1) / 15 ** 0.5
    mask = torch.zeros(b, cb)
    for i, n in enumerate(live):
        mask[i, :n] = 1
    return tuple(x.to(device) for x in (o, s, channels, wc, bc, w, bias,
                                        mask))


def _k5(*args):
    """The wrapper on ``_tail_inputs``' inputs (their FLOP count is not
    read)."""
    return melody_kernel.melody_tail(*args, embed_width=0)


# the serving shape (6 songs of 2-3 live channels in the bucket of 8, 128
# bars of 4 beats) and an odd one (33 bars of 3 beats: a ragged last tile)
CARD_SHAPES = [((6, 8, 128, 4), (2, 3, 2, 3, 3, 2)),
               ((3, 8, 33, 3), (1, 8, 0))]


@pytest.mark.card
@pytest.mark.parametrize("shape,live", CARD_SHAPES,
                         ids=lambda v: "x".join(map(str, v)))
def test_k5_against_the_plain_version_on_the_card(card, shape, live):
    args = _tail_inputs(*shape, live, seed=sum(shape), device=card)
    before = melody_kernel.melody_tail.launches
    with torch.inference_mode():
        got = _k5(*args)
        want = melody_kernel.melody_tail_plain(*args)
    torch.cuda.synchronize()
    assert melody_kernel.melody_tail.launches == before + 2
    assert got.shape == want.shape
    _assert_close(got.cpu().numpy(), want.cpu().numpy(), f"{shape}")


@pytest.mark.card
def test_k5_is_the_same_bits_run_to_run_and_in_a_replay(card):
    args = _tail_inputs(*CARD_SHAPES[0][0], CARD_SHAPES[0][1], seed=7,
                        device=card)
    with torch.inference_mode():
        runs = [_k5(*args) for _ in range(3)]
        assert all(torch.equal(r, runs[0]) for r in runs[1:])
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            _k5(*args)                              # warm-up off the graph
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = _k5(*args)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, runs[0])


@pytest.mark.card
def test_encoder_routes_agree_on_the_card(card):
    """The encoder on the card: K5 where no gradient is needed, the
    composition with autograd on; the fp32 rule between them."""
    enc = _encoder(PUBLISHED).to(card)
    args = _inputs(2, 8, 5, 4, PUBLISHED, MASKS["cb8"], device=card)
    before = melody_kernel.melody_tail.launches
    with torch.inference_mode():
        got = enc(*args)
    with torch.enable_grad():
        want = enc(*args)
    torch.cuda.synchronize()
    assert melody_kernel.melody_tail.launches == before + 2
    _assert_close(got.cpu().numpy(), want.detach().cpu().numpy())
