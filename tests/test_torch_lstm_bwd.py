"""The LSTM recurrence with its gradient on K4 (mst_torch.ops.lstm_kernel's
``LstmRecur``): the training form of the forward, the backward over saved
gates, and the dispatch that sends training's recurrences on the card to
them.

On the CPU: ``recur_saved_plain`` gives ``recur_plain``'s outputs bit for
bit; the plain backward over saved gates (``recur_bwd_plain`` and
``weight_grad``, which ``LstmRecur`` runs for CPU tensors) against
autograd through ``recur_plain``, at small (K, N, T, H) that include H not
divisible by the kernel's split, row counts that leave part of the last
row tile empty, a single step, and the modules with padded rows; a
float64 gradcheck; the FLOPs the route counts; the backward's launch plan
at every width.

On the card (the ``card`` fixture skips without one; this file imports
no JAX, so it runs there with ``python3 -m pytest --noconftest
tests/test_torch_lstm_bwd.py``): K4's training form bit-equal to its
serving form, K4's backward (``dgates``) and the weight gradient against
the plain versions on the same saved gates at the batch-1 training
step's (K, N, T, H) in fp32 and bf16, and a captured micro-step's
gradients with K4 against the same step on the loop.
"""

import numpy as np
import pytest
import torch

from mst_torch.config import ModelConfig
from mst_torch.device import strict_fp32
from mst_torch.ops import lstm, lstm_kernel
from mst_torch.ops.precision import precision
from mst_torch.runtime import flops

# (K, N, T, H) of the batch-1 training step's recurrences: the bar
# BiLSTMs, the style LSTM, song info's bar LSTM, the pitched beat LSTMs at
# 2 and 4 channel buckets, the unpitched one and song info's beat LSTM
B1_SHAPES = [(2, 1, 128, 64), (1, 1, 128, 192), (1, 1, 128, 8),
             (1, 256, 4, 64), (1, 512, 4, 64), (1, 128, 4, 64),
             (1, 128, 4, 9)]
# small shapes for the CPU: H not divisible by the split (9, 13), rows
# that leave a row tile part empty (5, 7), one step
SMALL_SHAPES = [(2, 5, 7, 9), (1, 7, 6, 13), (2, 3, 1, 4), (1, 1, 9, 8)]


def _inputs(k, n, t, h, seed=0, device="cpu"):
    """gates_x ~ N(0, 1), w_hh_t ~ U(+-1/sqrt(H)) (the modules' init) and
    an outputs' cotangent ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    gates = torch.randn(k, n, t, 4 * h, generator=g)
    w = (torch.rand(k, h, 4 * h, generator=g) * 2 - 1) / h ** 0.5
    dout = torch.randn(k, n, t, h, generator=g)
    return gates.to(device), w.to(device), dout.to(device)


def _assert_close(got, want, label=""):
    """tests/test_fused_tails.py's fp32-reassociation tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 + 2e-6 * np.abs(want).max(),
                               err_msg=label)


def _grads(fn, gates, w, dout, compute):
    """(outputs, d gates_x, d w_hh_t) of ``sum(fn(gates, w) * dout)``."""
    g = gates.clone().requires_grad_()
    w = w.clone().requires_grad_()
    with precision(compute):
        out = fn(g, w)
    (out * dout).sum().backward()
    return out.detach(), g.grad, w.grad


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SMALL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_saved_form_gives_the_loops_outputs(shape, compute):
    """The training form's plain version: the loop's outputs bit for bit,
    the saved activations in (0, 1) and (-1, 1), and each step's h equal
    to o tanh(c) of the saved values."""
    gates, w, _ = _inputs(*shape, seed=1)
    with precision(compute), torch.no_grad():
        want = lstm_kernel.recur_plain(gates, w)
    out, acts, cs = lstm_kernel.recur_saved_plain(
        gates, w, compute == "bfloat16")
    assert torch.equal(out, want)
    h = shape[3]
    si, sf, tg, so = acts.split(h, dim=-1)
    for sig in (si, sf, so):
        assert bool(((sig >= 0) & (sig <= 1)).all())
    assert bool((tg.abs() <= 1).all())
    assert torch.equal(so * torch.tanh(cs), out)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SMALL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_against_autograd_through_the_loop(shape, compute):
    """``LstmRecur`` on CPU tensors (the plain backward over saved gates
    and ``weight_grad``) against autograd through ``recur_plain``.

    fp32: the fp32-reassociation rule (the twin sums the carried dh's
    product and the weight gradient over all rows and steps at once;
    autograd sums a product a step and adds the steps). bf16: d gates_x
    under the same rule, since both round each step's carried dh to bf16
    from the same fp32 product; dW_hh within (T + 1) bf16 half-ulps of
    its largest value, since the loop rounds each step's weight product to
    bf16 and adds the T of them in bf16, where ``weight_grad`` sums them
    in fp32 and rounds once."""
    gates, w, dout = _inputs(*shape, seed=2)
    out, d_g, d_w = _grads(lstm_kernel.lstm_recur_train, gates, w, dout,
                           compute)
    want_out, want_g, want_w = _grads(lstm_kernel.recur_plain, gates, w,
                                      dout, compute)
    assert torch.equal(out, want_out)
    _assert_close(d_g, want_g, f"{shape} {compute} gates_x")
    if compute == "float32":
        _assert_close(d_w, want_w, f"{shape} {compute} w_hh_t")
    else:
        t = shape[2]
        bound = (t + 1) * 2.0 ** -9 * float(want_w.abs().max())
        assert float((d_w - want_w).abs().max()) <= bound


def test_gradcheck_in_float64():
    """The plain backward is the derivative of the plain forward: a
    float64 ``gradcheck`` of ``LstmRecur`` on CPU tensors, H not divisible
    by any split and two directions."""
    gates, w, _ = _inputs(2, 3, 4, 5, seed=3)
    gates = gates.double().requires_grad_()
    w = w.double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda g, ww: lstm_kernel.LstmRecur.apply(g, ww, False), (gates, w))


@pytest.mark.parametrize("kind", ["lstm", "bilstm"])
def test_modules_with_padded_rows_through_the_function(monkeypatch, kind):
    """The modules' parameter gradients with the recurrence as
    ``LstmRecur`` (the card's route, here on the CPU with its plain
    versions) against the loop's, with rows padded past their lengths
    (the BiLSTM's masked flip): the fp32-reassociation rule."""
    def run(recur):
        monkeypatch.setattr(lstm, "_recur", recur)
        mod = lstm.LSTM(6, 9) if kind == "lstm" else lstm.BiLSTM(6, 9)
        mod.reset_parameters(torch.Generator().manual_seed(4))
        x = torch.randn(3, 11, 6, generator=torch.Generator().manual_seed(5))
        lengths = torch.tensor([11, 4, 7])
        got = mod(x, lengths)
        out = got[0] if kind == "lstm" else got
        out = out if kind == "bilstm" else torch.cat([out, got[1][:, None]],
                                                     dim=1)
        (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum() \
            .backward()
        return {n: p.grad for n, p in mod.named_parameters()}

    got = run(lstm_kernel.lstm_recur_train)
    want = run(lstm_kernel.recur_plain)
    assert got.keys() == want.keys()
    for name in want:
        _assert_close(got[name], want[name], name)


def test_the_function_counts_the_loops_flops():
    """Forward and backward through ``LstmRecur`` count the loop's matmul
    FLOPs; the plain backward's own products for the carried dh are
    ``bwd_flops``, what K4's backward adds on the card."""
    k, n, t, h = 2, 3, 5, 4
    gates, w, dout = _inputs(k, n, t, h, seed=6)

    def fwd_bwd(fn):
        def run():
            g = gates.clone().requires_grad_()
            ww = w.clone().requires_grad_()
            (fn(g, ww) * dout).sum().backward()
        return flops.count_matmul_flops(run)

    assert fwd_bwd(lstm_kernel.lstm_recur_train) == \
        fwd_bwd(lstm_kernel.recur_plain)
    out, acts, cs = lstm_kernel.recur_saved_plain(gates, w, False)
    assert flops.count_matmul_flops(
        lstm_kernel.recur_bwd_plain, dout, acts, cs, w, False) == \
        lstm_kernel.bwd_flops(k, n, t, h)


def test_backward_reads_no_policy():
    """The backward runs on the autograd engine's thread on the card,
    which sees no precision policy: a bf16 forward's backward run outside
    the policy gives the gradients of one run inside it."""
    gates, w, dout = _inputs(1, 4, 6, 8, seed=7)
    g1, w1 = gates.clone().requires_grad_(), w.clone().requires_grad_()
    with precision("bfloat16"):
        out = lstm_kernel.lstm_recur_train(g1, w1)
    (out * dout).sum().backward()          # outside the policy
    g2, w2 = gates.clone().requires_grad_(), w.clone().requires_grad_()
    with precision("bfloat16"):
        (lstm_kernel.lstm_recur_train(g2, w2) * dout).sum().backward()
    assert torch.equal(g1.grad, g2.grad) and torch.equal(w1.grad, w2.grad)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("h", sorted({1, 3, 8, 9, 31, 64, 100, 101, 128,
                                      129, 192, 255, 256}))
@pytest.mark.parametrize("k,n", [(2, 1), (1, 512), (1, 200000)])
def test_backward_plan_takes_every_width(k, n, h, bf16):
    """The backward's launch shape is one the kernel takes: the
    forward's rules, with its four-times-wider exchange buffers within a
    block's shared memory, and one row a cluster on the bar axis."""
    p = lstm_kernel.plan(k, n, h, bf16, 132, bwd=True)
    assert p.cluster in (1, 2, 4, 8)
    assert p.cluster * p.units >= h > (p.cluster - 1) * p.units
    assert p.split in (1, 2, 4, 8) and (p.split == 1 or h >= 4 * p.split)
    assert p.threads <= lstm_kernel.MAX_THREADS
    assert p.rows_per_thread in (1, 2, 4, 8)
    assert p.smem_bytes <= lstm_kernel.SMEM_LIMIT
    assert p.smem_bytes == lstm_kernel._smem_bytes(
        h, p.units, p.rows, bf16, p.split, bwd=True)
    if k * n * p.cluster <= 132:
        assert p.rows == 1


def test_counters_are_registered():
    """A replay adds the launches its capture recorded to every counter of
    ``programs.COUNTERS``: the backward's two forms are among them."""
    from mst_torch.runtime import programs
    assert (lstm_kernel.lstm_recur_bwd, "launches") in programs.COUNTERS
    assert (lstm_kernel.lstm_recur_bwd, "launches_bf16") in \
        programs.COUNTERS


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    strict_fp32()
    return torch.device("cuda")


# Under bf16 compute the kernel and the plain backward each round the
# carried dh to bf16 from fp32 products summed in other orders; where the
# two straddle a rounding midpoint they differ by a bf16 ulp, which the
# earlier steps carry. So each value is held within BF16_MAX_REL of the
# largest |value|, the bound the forward's bf16 form is held to
# (tests/test_torch_lstm_kernel.py).
BF16_MAX_REL = 2 ** -12


@pytest.mark.card
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", B1_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k4_backward_against_the_plain_version_on_the_card(card, shape,
                                                            compute):
    """The training form's outputs bit-equal to the serving form's; its
    saved activations and c, and K4's backward and the weight gradient
    from its saved gates, against the plain versions on the card: fp32
    within the fp32-reassociation rule, bf16 within ``BF16_MAX_REL``."""
    bf16 = compute == "bfloat16"
    k, n, t, h = shape
    gates, w, dout = _inputs(*shape, seed=sum(shape), device=card)
    before = (lstm_kernel.lstm_recur_bwd.launches,
              lstm_kernel.lstm_recur_bwd.launches_bf16)
    with precision(compute), torch.no_grad():
        serve = lstm_kernel.lstm_recur(gates, w)
        out, acts, cs = lstm_kernel._launch(gates, w, bf16, train=True)
        _, want_acts, want_cs = lstm_kernel.recur_saved_plain(gates, w, bf16)
        p = lstm_kernel.plan(k, n, h, bf16, lstm_kernel._sm_count(0),
                             bwd=True)
        dg = lstm_kernel.lstm_recur_bwd(dout, acts, cs, w, p, bf16)
        want_dg = lstm_kernel.recur_bwd_plain(dout, acts, cs, w, bf16)
        dw = lstm_kernel.weight_grad(out, dg, bf16)
        want_dw = lstm_kernel.weight_grad(out, want_dg, bf16)
    torch.cuda.synchronize()
    assert (lstm_kernel.lstm_recur_bwd.launches,
            lstm_kernel.lstm_recur_bwd.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    assert torch.equal(serve, out)
    pairs = [("acts", acts, want_acts), ("c", cs, want_cs),
             ("dgates", dg, want_dg), ("dw", dw, want_dw)]
    for label, got, want in pairs:
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if bf16:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=BF16_MAX_REL * np.abs(want).max(),
                err_msg=f"{shape} {compute} {label}")
        else:
            _assert_close(got, want, f"{shape} {compute} {label}")


# A replayed micro-step's gradients, K4 against the loop, per leaf: the
# kernels sum each dot product in their own order, and the step carries
# those last-bit differences through 128 bar steps and the layers around
# them. Per value within GRAD_MAX_REL of the leaf's largest |value|; the
# b1 cell holds the norms of the first gradient's leaves to 1e-4.
GRAD_MAX_REL = 1e-4


@pytest.mark.card
def test_captured_micro_step_gradients_match_the_loops(card, monkeypatch):
    """Two micro-steps of one batch-1 fp32 song (``iter_size`` 4: no
    apply), captured and then replayed, from the same init: the losses
    and accumulated gradients with K4 against the same steps with the
    recurrences on the loop; K4 launches its forward and its backward
    once a recurrence a micro-step, replays included."""
    import os

    from mst_torch.config import Config, TrainConfig
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    tr.reproducible_backends()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    song = get_model_input(os.path.join(root, "mst_torch", "assets",
                                        "smoke", "comp_0.mid"))[1]
    config = Config(model=ModelConfig(), train=TrainConfig(iter_size=4))
    t = config.train
    cap = t.max_total_bars // song.n_channels
    rb = tr.bucket_shape(min(song.n_bars, cap), t.bar_buckets)
    batch = tr.device_batch_from_songs(
        [song], tr.bucket_shape(song.n_channels, t.channel_buckets), rb,
        bar_cap=[min(cap, rb)], device="cuda")
    has_u = batch.unpitched is not None
    results = {}
    for route in ("k4", "loop"):
        if route == "loop":
            monkeypatch.setattr(lstm, "lstm_recur_train",
                                lstm_kernel.recur_plain)
        state = tr.create_train_state(config, device="cuda", seed=108)
        step = tr.make_train_step(config, has_u, capture=True)
        n0 = (lstm_kernel.lstm_recur.launches,
              lstm_kernel.lstm_recur_bwd.launches)
        losses = [step(state, batch)[1].cpu() for _ in range(2)]
        torch.cuda.synchronize()
        n1 = (lstm_kernel.lstm_recur.launches,
              lstm_kernel.lstm_recur_bwd.launches)
        assert len(state.programs.graphs) == 1
        results[route] = (losses, n1[0] - n0[0], n1[1] - n0[1],
                          {n: p.grad.detach().clone()
                           for n, p in state.model.named_parameters()})
    (l_k4, fwd, bwd, g_k4), (l_loop, fwd0, bwd0, g_loop) = (results["k4"],
                                                           results["loop"])
    recurrences = 7 if has_u else 5
    assert (fwd, bwd, fwd0, bwd0) == (2 * recurrences, 2 * recurrences, 0,
                                      0)
    for a, b in zip(l_k4, l_loop):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert g_k4.keys() == g_loop.keys()
    worst = {}
    for name in g_loop:
        got, want = g_k4[name], g_loop[name]
        top = float(want.abs().max())
        worst[name] = float((got - want).abs().max()) / max(top, 1e-30)
    name = max(worst, key=worst.get)
    print(f"worst leaf {name}: {worst[name]:.3e} of its largest |value|")
    assert worst[name] <= GRAD_MAX_REL, (name, worst[name])
