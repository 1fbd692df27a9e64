"""K4, the LSTM recurrence kernel (mst_torch.ops.lstm_kernel), and the
dispatch of mst_torch.ops.lstm that sends serving's recurrences to it.

On the CPU: the dispatch takes the plain loop on the CPU, K4 on a CUDA
tensor that needs no gradient, and K4 with its backward
(``lstm_recur_train``) on a CUDA tensor where autograd records; the
wrapper runs ``recur_plain`` for CPU tensors, bit for bit, and refuses a
width above ``MAX_FEATURES``; ``plan`` gives a launch shape the kernel
takes for every width up to the limit; the launch counters are registered
for replays; a launch counts the loop's matmul FLOPs; the modules' outputs
and counts on the CPU are the loop's.

On the card (the ``card`` fixture skips without one; this file imports no
JAX, so it runs there with ``python3 -m pytest --noconftest
tests/test_torch_lstm_kernel.py``): K4 against ``recur_plain`` on the card
at the main path's (K, N, T, H) shapes, a bar-bucket edge and the widest
width, under fp32 compute within the fp32-reassociation rule
(tests/test_torch_train.py's ``_assert_close``: K4 sums each dot product in
ascending depth, cuBLAS in its own order). Under bf16 compute both round
each step's h to bf16; where the two fp32 h straddle a bf16 rounding
midpoint, the rounded operands differ by a bf16 ulp (2**-8 of the value),
which the later steps carry, so each value is held within ``BF16_MAX_REL``
of the largest |value| (the first card run measured 7.3e-5 of it at
H = 192; chip_smoke.py's ``K4_BF16_MAX_REL``).
"""

import numpy as np
import pytest
import torch

from mst_torch.config import ModelConfig
from mst_torch.device import strict_fp32
from mst_torch.ops import lstm, lstm_kernel
from mst_torch.ops.flop_scope import add_bmm_flops
from mst_torch.ops.precision import precision
from mst_torch.runtime import flops, programs

# (K, N, T, H) of the serving path's recurrences: the bar BiLSTMs, the
# style encoder's bar LSTM, song info's bar LSTM, the beat LSTMs of
# extraction at two batch sizes and song info's beat LSTM
MAIN_SHAPES = [(2, 6, 128, 64), (1, 6, 128, 192), (1, 12, 128, 8),
               (1, 6144, 4, 64), (1, 768, 4, 64), (1, 1536, 4, 9)]
# the largest bar bucket, and the widest width K4 takes (a cluster of 8),
# on both axes
EDGE_SHAPES = [(2, 6, 1024, 64), (1, 6, 32, 256), (1, 4096, 4, 256)]
BF16_MAX_REL = 2 ** -12


def _assert_close(got, want, label=""):
    """tests/test_fused_tails.py's fp32-reassociation tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 + 2e-6 * np.abs(want).max(),
                               err_msg=label)


def _inputs(k, n, t, h, seed=0, device="cpu"):
    """gates_x ~ N(0, 1) and w_hh_t ~ U(+-1/sqrt(H)), the modules' init."""
    g = torch.Generator().manual_seed(seed)
    gates = torch.randn(k, n, t, 4 * h, generator=g)
    w = (torch.rand(k, h, 4 * h, generator=g) * 2 - 1) / h ** 0.5
    return gates.to(device), w.to(device)


def _widths():
    """H of every LSTM and BiLSTM of the model at ``ModelConfig()``."""
    from mst_torch.models import StyleTransferModel
    model = StyleTransferModel(ModelConfig())
    return {m.features for m in model.modules()
            if isinstance(m, (lstm.LSTM, lstm.BiLSTM))}


# ------------------------------------------------------------ on the CPU

class _Recorder:
    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, gates_x, w_hh_t):
        self.calls.append(self.name)
        return self.name


class _FakeCuda:
    """What ``lstm._recur`` reads of a CUDA tensor."""
    is_cuda = True

    def __init__(self, requires_grad):
        self.requires_grad = requires_grad


@pytest.mark.parametrize("where,grad,needs,want", [
    ("cpu", False, False, "loop"),
    ("cpu", True, True, "loop"),
    ("cuda", True, True, "train"),
    ("cuda", True, False, "kernel"),
    ("cuda", False, True, "kernel"),
], ids=["cpu-no-grad", "cpu-grad", "cuda-grad", "cuda-grad-but-no-leaf",
        "cuda-no-grad"])
def test_dispatch(monkeypatch, where, grad, needs, want):
    """K4 on the card where no gradient is needed, K4 with its backward
    where autograd records (training); the loop on the CPU."""
    kernel, loop = _Recorder("kernel"), _Recorder("loop")
    train = _Recorder("train")
    monkeypatch.setattr(lstm, "lstm_recur", kernel)
    monkeypatch.setattr(lstm, "lstm_recur_train", train)
    monkeypatch.setattr(lstm, "recur_plain", loop)
    if where == "cpu":
        gates, w = _inputs(1, 2, 3, 4)
        gates.requires_grad_(needs)
    else:
        gates, w = _FakeCuda(needs), _FakeCuda(False)
    with torch.set_grad_enabled(grad):
        assert lstm._recur(gates, w) == want


@pytest.mark.parametrize("mode", ["inference", "grad"])
@pytest.mark.parametrize("kind", ["lstm", "bilstm"])
def test_modules_on_the_cpu_run_the_loop(monkeypatch, kind, mode):
    """On the CPU the modules never reach K4's wrapper, under
    ``inference_mode`` as with autograd on, and their outputs are the
    loop's: the module with ``_recur`` replaced by ``recur_plain`` gives
    the same bits."""
    def refused(*args):
        raise AssertionError("K4 called on the CPU")

    monkeypatch.setattr(lstm, "lstm_recur", refused)
    torch.manual_seed(3)
    mod = lstm.LSTM(6, 5) if kind == "lstm" else lstm.BiLSTM(6, 5)
    mod.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(3, 9, 6)
    lengths = torch.tensor([9, 4, 7])
    ctx = torch.inference_mode() if mode == "inference" else \
        torch.enable_grad()
    with ctx:
        got = mod(x, lengths)
    got = got[0] if kind == "lstm" else got
    monkeypatch.setattr(lstm, "_recur", lstm_kernel.recur_plain)
    with torch.no_grad():
        want = mod(x, lengths)
    want = want[0] if kind == "lstm" else want
    assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_wrapper_runs_the_plain_version_on_the_cpu(compute):
    gates, w = _inputs(2, 5, 7, 9)
    with precision(compute), torch.inference_mode():
        got = lstm_kernel.lstm_recur(gates, w)
        want = lstm_kernel.recur_plain(gates, w)
    assert got.shape == (2, 5, 7, 9) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_width_above_the_limit_raises():
    limit = lstm_kernel.MAX_FEATURES
    gates, w = _inputs(1, 2, 3, limit + 1)
    with pytest.raises(ValueError, match=str(limit)):
        lstm_kernel.lstm_recur(gates, w)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match=str(limit)):
            lstm_kernel.plan(1, 6, limit + 1, bf16, 132)


@pytest.mark.parametrize("case", ["gates dtype", "w shape", "gates rank"])
def test_wrapper_checks_its_inputs(case):
    gates, w = _inputs(1, 2, 3, 4)
    if case == "gates dtype":
        gates = gates.double()
    elif case == "w shape":
        w = w[:, :, :8]
    else:
        gates = gates[0]
    with pytest.raises(ValueError, match="lstm_recur"):
        lstm_kernel.lstm_recur(gates, w)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("h", sorted({1, 3, 8, 9, 31, 64, 100, 101, 128,
                                      129, 192, 255, 256}))
@pytest.mark.parametrize("k,n", [(2, 6), (1, 12), (1, 1536), (1, 200000)])
def test_plan_takes_every_width(k, n, h, bf16):
    """A launch shape the kernel takes (csrc/lstm_recur.cu's checks): every
    block owns at least one unit and the cluster covers H, at most 256
    threads, 1-8 rows and at least 4 depths a lane, the shared memory a
    block has; one row a cluster on the bar axis."""
    p = lstm_kernel.plan(k, n, h, bf16, 132)
    assert p.cluster in (1, 2, 4, 8)
    assert p.cluster * p.units >= h > (p.cluster - 1) * p.units
    assert p.split in (1, 2, 4, 8) and (p.split == 1 or h >= 4 * p.split)
    assert p.threads <= lstm_kernel.MAX_THREADS
    assert p.rows_per_thread in (1, 2, 4, 8)
    assert p.smem_bytes <= lstm_kernel.SMEM_LIMIT
    if k * n * p.cluster <= 132:
        assert p.rows == 1


def test_plan_of_the_model_widths():
    """Every width of ``ModelConfig()`` has a plan, and the style LSTM's
    H = 192 splits over a cluster: 4 blocks in fp32, 2 in bf16."""
    widths = _widths()
    assert widths == {8, 9, 64, 192}
    for h in widths:
        for bf16 in (False, True):
            lstm_kernel.plan(1, 6, h, bf16, 132)
    assert lstm_kernel.plan(1, 6, 192, False, 132).cluster == 4
    assert lstm_kernel.plan(1, 6, 192, True, 132).cluster == 2
    assert lstm_kernel.plan(2, 6, 64, False, 132).cluster == 1


def test_counters_are_registered():
    """A replay adds the launches its capture recorded to every counter of
    ``programs.COUNTERS``: K4's two forms are among them."""
    assert (lstm_kernel.lstm_recur, "launches") in programs.COUNTERS
    assert (lstm_kernel.lstm_recur, "launches_bf16") in programs.COUNTERS


def test_kernel_route_counts_the_loops_flops():
    """The loop's matmul FLOPs are 2 K N T H 4H; the kernel's route adds
    exactly that (``add_bmm_flops``), also to a count that a scope inside
    takes back."""
    k, n, t, h = 2, 3, 5, 4
    gates, w = _inputs(k, n, t, h)
    want = 2 * k * n * t * h * 4 * h
    assert flops.count_matmul_flops(lstm_kernel.recur_plain, gates, w) \
        == want
    with flops.MatmulFlops() as count:
        add_bmm_flops(want)
    assert count.total == want
    with flops.MatmulFlops() as count:
        with flops.uncounted():
            add_bmm_flops(want)
    assert count.total == 0


@pytest.mark.parametrize("kind", ["lstm", "bilstm"])
def test_module_flops_in_inference_mode(kind):
    """A module's count under ``inference_mode`` (serving) on the CPU:
    the input projection and the loop's products."""
    n, t, d, h = 3, 9, 6, 5
    mod = lstm.LSTM(d, h) if kind == "lstm" else lstm.BiLSTM(d, h)
    k = 1 if kind == "lstm" else 2
    with torch.inference_mode():
        got = flops.count_matmul_flops(mod, torch.randn(n, t, d))
    assert got == k * 2 * n * t * 4 * h * (d + h)


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MAIN_SHAPES + EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k4_against_the_loop_on_the_card(card, shape, compute):
    strict_fp32()
    gates, w = _inputs(*shape, seed=sum(shape), device=card)
    before = (lstm_kernel.lstm_recur.launches,
              lstm_kernel.lstm_recur.launches_bf16)
    with precision(compute), torch.inference_mode():
        got = lstm_kernel.lstm_recur(gates, w)
        want = lstm_kernel.recur_plain(gates, w)
    torch.cuda.synchronize()
    bf16 = compute == "bfloat16"
    assert (lstm_kernel.lstm_recur.launches,
            lstm_kernel.lstm_recur.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if bf16:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_MAX_REL * np.abs(want).max(),
            err_msg=f"{shape} {compute}")
    else:
        _assert_close(got, want, f"{shape} {compute}")


@pytest.mark.card
def test_k4_takes_a_transposed_weight_on_the_card(card):
    """The modules pass ``weight_hh_l0.t()[None]``, a strided view."""
    gates, w = _inputs(1, 6, 16, 64, device=card)
    w_t = w[0].t().contiguous().t()[None]
    assert not w_t.is_contiguous()
    with torch.inference_mode():
        assert torch.equal(lstm_kernel.lstm_recur(gates, w_t),
                           lstm_kernel.lstm_recur(gates, w))


@pytest.mark.card
def test_k4_counts_the_loops_flops_on_the_card(card):
    gates, w = _inputs(2, 6, 16, 64, device=card)
    with torch.inference_mode():
        got = flops.count_matmul_flops(lstm_kernel.lstm_recur, gates, w)
    assert got == 2 * 2 * 6 * 16 * 64 * 256
