"""The port's matmul-FLOP counter (mst_torch.runtime.flops) against
mst_tpu's jaxpr count (mst_tpu.runtime.flops), on the CPU.

Every case feeds the same numpy inputs (and, through
``weights.state_dict_from_flax``, the same parameters) to both packages
and requires equal counts, as integers. Two programs count otherwise,
each for a reason named where it is tested and pinned exactly:

- a recurrence's gradient: JAX's transposed scan forms the cotangent of the
  zero initial carry (one ``h @ W_hh`` product of the last backward step,
  which the program then drops); torch's autograd forms no gradient for a
  tensor that needs none. JAX counts 2 K N H 4H more per recurrence of K
  directions over N rows with H units;
- a strided convolution's input gradient (which no step of the model
  takes: its input is the raster): JAX counts the transposed convolution
  over the stride-dilated cotangent as a dense one, 2 N C_in W_in C_out K;
  torch counts its multiply-adds, the forward's 2 N C_out W_out C_in K.

The note-grid tail counts 0 on every route in both packages.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu import transfer as jt
from mst_tpu.config import Config as JConfig
from mst_tpu.config import ModelConfig as JModelConfig
from mst_tpu.config import TrainConfig as JTrainConfig
from mst_tpu.models import StyleTransferModel as JModel
from mst_tpu.models.layers import Conv1d as JConv1d
from mst_tpu.ops import lstm as jlstm
from mst_tpu.ops import precision as jp
from mst_tpu.runtime import flops as jf
from mst_tpu.runtime import train as jtr
from mst_torch import transfer as tt
from mst_torch import weights
from mst_torch.config import Config, ModelConfig, TrainConfig
from mst_torch.models import StyleTransferModel
from mst_torch.models.layers import Conv1d
from mst_torch.ops import grid_kernel, lstm as tlstm, precision as tp
from mst_torch.runtime import flops
from mst_torch.runtime import train as ttr
from tests.test_torch_model import NARROW, _params_like
from tests.test_torch_train import songs  # noqa: F401  (a fixture)

H100 = "NVIDIA H100 80GB HBM3"


def _outputs(y):
    """The full outputs of an LSTM (which also returns its last step) or
    of a BiLSTM."""
    return y[0] if isinstance(y, tuple) else y


def _flax_init(module, *args):
    return _params_like(module.init, jax.random.PRNGKey(0),
                        *(jnp.asarray(a) for a in args))


# ---------------------------------------------------- tests/test_flops.py

def test_plain_matmul():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=(8, 16)).astype(np.float32)
    want = jf.count_matmul_flops(lambda a, b: a @ b, jnp.asarray(a),
                                 jnp.asarray(b))
    got = flops.count_matmul_flops(torch.matmul, torch.from_numpy(a),
                                   torch.from_numpy(b))
    assert isinstance(got, int)
    assert got == want == 2 * 4 * 16 * 8


def _recurrence_carry_flops(model_fn):
    """2 K N H 4H summed over the recurrences ``model_fn`` runs: JAX's
    extra count for the cotangent of each scan's initial carry."""
    seen = []
    recur = tlstm._recur

    def recording(gates_x, w_hh_t):
        k, n, _, four_h = gates_x.shape
        seen.append(2 * k * n * w_hh_t.shape[1] * four_h)
        return recur(gates_x, w_hh_t)

    tlstm._recur = recording
    try:
        with torch.no_grad():
            model_fn()
    finally:
        tlstm._recur = recur
    return sum(seen)


@pytest.mark.parametrize("kind", ["lstm", "bilstm"])
@pytest.mark.parametrize("T", [9, 12])
def test_lstm_scan(kind, T):
    """The port's recurrence, a Python loop of matmuls, against mst_tpu's
    scanned LSTM: forward counts equal (scan length x body); the gradient
    differs by the initial carry's cotangent alone."""
    rng = np.random.default_rng(T)
    x = rng.normal(size=(3, T, 6)).astype(np.float32)
    j_mod = jlstm.LSTM(5) if kind == "lstm" else jlstm.BiLSTM(5)
    t_mod = tlstm.LSTM(6, 5) if kind == "lstm" else tlstm.BiLSTM(6, 5)
    params = _flax_init(j_mod, x)
    t_mod.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    want = jf.count_matmul_flops(lambda p, x: j_mod.apply(p, x), params, jx)
    got = flops.count_matmul_flops(t_mod, tx)
    assert got == want > 0

    want_g = jf.count_matmul_flops(jax.grad(
        lambda p, x: _outputs(j_mod.apply(p, x)).sum(), argnums=(0, 1)),
        params, jx)
    tx.requires_grad_(True)
    got_g = flops.count_matmul_flops(
        lambda: _outputs(t_mod(tx)).sum().backward())
    carry = _recurrence_carry_flops(lambda: t_mod(tx))
    assert carry == (1 if kind == "lstm" else 2) * 2 * 3 * 5 * 20
    assert want_g - got_g == carry


@pytest.mark.parametrize("grad_input", [False, True],
                         ids=["kernel-grad", "both-grads"])
def test_conv_at_the_encoder_layout(grad_input):
    """``beats_conv``'s layout (N, 50, 56) -> (N, 33, 8), kernel 14,
    stride 7, padding 4: the forward, and the gradient with respect to the
    kernel (the raster input needs none) or to both, where JAX counts its
    transposed convolutions and torch ``convolution_backward``."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 50, 56)).astype(np.float32)
    j_mod = JConv1d(33, kernel_size=14, stride=7, padding=4)
    t_mod = Conv1d(50, 33, 14, 7, 4)
    params = _flax_init(j_mod, x)
    t_mod.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    want = jf.count_matmul_flops(lambda p: j_mod.apply(p, jx), params)
    got = flops.count_matmul_flops(t_mod, tx)
    assert got == want == 2 * (6 * 33 * 8) * 50 * 14

    argnums = (0, 1) if grad_input else 0
    want_g = jf.count_matmul_flops(jax.grad(
        lambda p, x: j_mod.apply(p, x).sum(), argnums=argnums), params, jx)
    tx.requires_grad_(grad_input)
    got_g = flops.count_matmul_flops(lambda: t_mod(tx).sum().backward())
    assert got_g == (3 if grad_input else 2) * want
    # the input's gradient is a transposed convolution over the
    # stride-dilated cotangent: JAX counts it as a dense convolution over
    # the input's 56 positions, torch by its MACs (the forward's, over the
    # 8 output positions)
    dilated = 2 * 6 * 50 * 33 * 14 * (56 - 8) if grad_input else 0
    assert want_g - got_g == dilated


def test_grad_counts_forward_and_backward():
    """value_and_grad of y = sum(x @ w): the forward product and w's
    transpose (x needs no gradient) in both packages."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    jx = jnp.asarray(x)
    want = jf.count_matmul_flops(
        jax.value_and_grad(lambda w: (jx @ w).sum()), jnp.asarray(w))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w).requires_grad_(True)
    got = flops.count_matmul_flops(lambda: (tx @ tw).sum().backward())
    fwd = flops.count_matmul_flops(torch.matmul, tx, tw.detach())
    assert got == want == 2 * fwd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_product_backward_skips_operands_without_grad(dtype):
    """Under bf16 compute the backward of ``precision.matmul`` forms a
    gradient only for an operand that needs one, as JAX transposes only
    what it differentiates (a constant operand used to get a product that
    was thrown away)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    jx = jnp.asarray(x)

    def j_loss(w):
        with jp.precision(dtype):
            return jp.matmul(jx, w).sum()

    want = jf.count_matmul_flops(jax.grad(j_loss), jnp.asarray(w))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w).requires_grad_(True)

    def t_step():
        with tp.precision(dtype):
            tp.matmul(tx, tw).sum().backward()

    got = flops.count_matmul_flops(t_step)
    assert got == want == 2 * (2 * 2 * 16 * 32 * 64)
    assert tx.grad is None and tw.grad.dtype == torch.float32


def test_bmm_with_out_dtype_is_counted():
    """The card's bf16 products (``torch.bmm``/``torch.mm`` with
    ``out_dtype=float32``, mst_torch.ops.precision) are counted; torch's
    own bmm formula refuses the ``out_dtype`` overload. Meta tensors run
    the op's shape logic on the CPU."""
    a = torch.empty(3, 8, 16, dtype=torch.bfloat16, device="meta")
    b = torch.empty(3, 16, 4, dtype=torch.bfloat16, device="meta")
    for fn, args, want in ((torch.bmm, (a, b), 2 * 3 * 8 * 4 * 16),
                           (torch.mm, (a[0], b[0]), 2 * 8 * 4 * 16)):
        got = flops.count_matmul_flops(fn, *args, out_dtype=torch.float32)
        assert got == want, fn


# ------------------------------------------------------------ the tail

def _tail_inputs(dtype, lead=(2, 3, 4)):
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return (t(*lead, 8, 30).to(dtype), t(*lead, 7, 30).to(dtype), t(30, 5),
            t(*lead, 56, 5), [1.0, 2.0, 0.5, 3.0, 1.5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_tail_counts_zero_on_the_plain_route(dtype):
    """K2's and K3's plain versions, alone and as ``GridTail``'s forward
    and backward, count 0, as every form of the tail does in mst_tpu
    (no ``dot_general``); ``grid_tail_bwd_plain``'s ct_w product is taken
    back by ``uncounted``."""
    xo, xd, w, rest, scale = _tail_inputs(dtype)
    out = grid_kernel.grid_tail_plain(xo, xd, w, rest, scale)
    ct = torch.ones_like(out)
    assert flops.count_matmul_flops(grid_kernel.grid_tail_plain, xo, xd, w,
                                    rest, scale) == 0
    assert flops.count_matmul_flops(grid_kernel.grid_tail_bwd_plain, xo,
                                    xd, out, ct, w, scale) == 0
    # the product that uncounted takes back is there to be counted
    n = xo.numel() // (8 * 30)
    assert flops.count_matmul_flops(
        lambda: torch.ones(30, n * 56) @ torch.ones(n * 56, 5)) > 0

    leaves = [t.clone().requires_grad_(True) for t in (xo, xd, w, rest)]

    def step():
        grid_kernel.grid_tail(*leaves, scale).float().sum().backward()

    assert flops.count_matmul_flops(step) == 0
    assert all(t.grad is not None for t in leaves)

    j_args = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 and i < 2 else jnp.float32)
        for i, t in enumerate((xo, xd, w, rest))]
    # mst_tpu's forms: the Pallas kernels (fp32 only; interpreted on the
    # CPU), the jnp forms with their gradients, the serving form forward
    from mst_tpu.ops import pallas_grid
    forms = [pallas_grid._tail_plain, pallas_grid._tail_jnp]
    if dtype == torch.float32:
        forms.append(lambda *a: pallas_grid.fused_grid_tail(*a,
                                                            interpret=True))
    for fn in forms:
        assert jf.count_matmul_flops(jax.grad(
            lambda *a: fn(*a, tuple(scale)).astype(jnp.float32).sum(),
            argnums=(0, 1, 2, 3)), *j_args) == 0
    assert jf.count_matmul_flops(pallas_grid._tail_unrolled, *j_args,
                                 tuple(scale)) == 0


def test_uncounted_nests_and_is_inert_without_a_count():
    a = torch.ones(4, 8)
    b = torch.ones(8, 2)
    with flops.uncounted():
        a @ b                       # no count open: nothing to take back
    with flops.MatmulFlops() as count:
        a @ b
        with flops.uncounted():
            a @ b
            with flops.uncounted():
                a @ b
            a @ b
        a @ b
    assert count.total == 2 * (2 * 4 * 2 * 8)


@pytest.mark.parametrize("scope_on", ["main", "other"])
def test_uncounted_leaves_other_threads_counts_alone(scope_on):
    """A scope open on one thread takes nothing from a count on another:
    the other thread's matmul, run while the scope is open, stays
    counted, and so does the counting thread's own."""
    import threading

    a, b = torch.ones(4, 8), torch.ones(8, 2)
    scope_open, counted = threading.Event(), threading.Event()
    totals = []

    def scope():
        with flops.uncounted():
            scope_open.set()
            assert counted.wait(30)
            a @ b

    def count():
        assert scope_open.wait(30)
        with flops.MatmulFlops() as c:
            a @ b
        counted.set()
        totals.append(c.total)

    main, other = (scope, count) if scope_on == "main" else (count, scope)
    thread = threading.Thread(target=other)
    thread.start()
    main()
    thread.join(30)
    assert totals == [2 * 4 * 2 * 8]


# ------------------------------------------------------ the train step

@pytest.fixture(scope="module")
def narrow_params():
    j_model = JModel(JModelConfig(**NARROW))
    return _params_like(
        j_model.init, jax.random.PRNGKey(1), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]), jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))


def _j_state(params, config):
    opt = jtr.make_optimizer(config)
    return jtr.TrainState(
        params=params, opt_state=opt.init(params),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, params),
        micro_step=jnp.zeros((), jnp.int32), opt_step=jnp.zeros((), jnp.int32))


def _t_state(params, config):
    model = StyleTransferModel(config.model)
    model.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    return ttr.create_train_state(config, device="cpu", model=model)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 250], ids=["percussion", "no-percussion"])
def test_train_step_counts(songs, narrow_params, seed, dtype, remat):
    """One micro-step (forward, backward, and with remat the recompute) of
    a device-built batch of one song at NARROW widths, under the fp32 or
    the bf16 policies: mst_tpu's ``make_train_step`` traced, the port's
    run. They differ by the initial carries' cotangents alone."""
    policy = dict(compute_dtype=dtype, storage_dtype=dtype)
    j_config = JConfig(model=JModelConfig(**NARROW, **policy),
                       train=JTrainConfig(remat=remat))
    t_config = Config(model=ModelConfig(**NARROW, **policy),
                      train=TrainConfig(remat=remat))
    j_song, t_song = songs[seed]
    j_batch = jtr.device_batch_from_songs([j_song], 2, 8, bar_cap=8)
    t_batch = ttr.device_batch_from_songs([t_song], 2, 8, bar_cap=8,
                                          device="cpu")
    has_u = t_batch.unpitched is not None
    assert has_u == (seed == 0)
    step = jtr.make_train_step(JModel(j_config.model), j_config, has_u,
                               fetch_losses=False)
    want = jf.count_matmul_flops(step, _j_state(narrow_params, j_config),
                                 j_batch)
    state = _t_state(narrow_params, t_config)
    got = flops.count_matmul_flops(ttr.make_train_step(t_config, has_u),
                                   state, t_batch)
    assert state.micro_step == 1          # the counted step was taken
    with tp.precision(dtype, storage=dtype):
        carry = _recurrence_carry_flops(lambda: ttr.loss_fn(
            state.model, t_batch, has_u))
    assert carry > 0
    assert want - got == carry, (want, got, carry)


def test_train_step_flops_scale_with_bars(narrow_params):
    """tests/test_flops.py's check on the port: the step's count grows
    about linearly in the bar axis (R 8 -> 16)."""
    config = Config(model=ModelConfig(**NARROW))
    state = _t_state(narrow_params, config)
    step = ttr.make_train_step(config, False)

    def count(R):
        B, C, T = 1, 2, 4
        instf = torch.zeros(B, C, 51)
        instf[:, :, 0] = 1.0
        used = torch.zeros(B, 41)
        used[:, 0] = 1.0
        batch = ttr.Batch(
            mode=torch.tensor([[1.0, 0.0]]), bpm=torch.tensor([120.0]),
            pitched=torch.zeros(B, C, R, T, 10, 56 * 5),
            instruments_features=instf, unpitched=None,
            used_instruments=used,
            bar_lengths=torch.full((B,), R, dtype=torch.int64),
            channel_mask=torch.ones(B, C), uchannel_mask=None)
        return flops.count_matmul_flops(step, state, batch)

    f8, f16 = count(8), count(16)
    assert f8 > 0
    assert 1.7 < f16 / f8 < 2.2, f16 / f8


# ------------------------------------------------------ the transfer

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transfer_request_count(tmp_path, dtype):
    """A narrow request, two compositions with percussion in one style
    (mst_tpu's single fused program; 4 apply jobs at Cb 8, Rb 64, T 4):
    ``count_matmul_flops(transfer_styles, ...)`` against
    ``replay_log_flops`` of mst_tpu's call log, on the same songs and
    weights (the velocity bias sparsified, as ``demo_params``), equal: both
    compactions take each job's inclusive block prefixes as one (G, 128) @
    (128, 128) product per note family (mst_tpu/transfer.py:187-188). Each
    side is counted on a second request, so that its capacity ladder,
    started from the first request's hints, dispatches once."""
    from tests.test_torch_transfer import _write_songs

    j_model = JModel(JModelConfig(**NARROW, compute_dtype=dtype))
    params = _params_like(
        j_model.init, jax.random.PRNGKey(1), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]), jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    params = jt.sparsify_velocity_bias(dict(params))
    j_bundle = jt.ModelBundle(model=j_model, params=params)
    model = StyleTransferModel(ModelConfig(**NARROW, compute_dtype=dtype))
    model.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    t_bundle = tt.ModelBundle(model=model, device="cpu")
    comps = _write_songs(tmp_path, (0, 245))
    styles = _write_songs(tmp_path, (235,))

    jt.transfer_styles(j_bundle, comps, styles, str(tmp_path / "warm"))
    j_bundle.call_log = []
    jt.transfer_styles(j_bundle, comps, styles, str(tmp_path / "jax"))
    assert [key.split(":")[0] for key, _, _ in j_bundle.call_log] == \
        ["transfer_fused"]
    want = jf.replay_log_flops(j_bundle._raw, j_bundle.call_log)
    tt.transfer_styles(t_bundle, comps, styles, str(tmp_path / "warm_t"))
    runs = sum(t_bundle.programs.runs.values())
    got = flops.count_matmul_flops(tt.transfer_styles, t_bundle, comps,
                                   styles, str(tmp_path / "torch"))
    assert sum(t_bundle.programs.runs.values()) == runs + 1
    assert got > 0
    assert got == want


# ------------------------------------------------------------ the peaks

def _as_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None:
                        name)


def test_mfu_math(monkeypatch):
    _as_card(monkeypatch, H100)
    assert flops.device_peak_flops("bfloat16") == 989e12
    assert flops.device_peak_flops(torch.float32, "cuda:0") == 67e12
    assert np.isclose(flops.mfu(1e12, 1.0, "bfloat16"), 1e12 / 989e12)
    assert np.isclose(flops.mfu(7.91e9, 0.4, "float32"),
                      7.91e9 / 0.4 / 67e12)


def test_device_peak_flops_raises_off_the_table(monkeypatch):
    """No fallback: the CPU, a machine without a card, an unknown card and
    an unknown dtype raise (mst_tpu falls back to v5e's numbers)."""
    with pytest.raises(ValueError, match="cpu"):
        flops.device_peak_flops("float32", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flops.device_peak_flops("float32")
    _as_card(monkeypatch, "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100"):
        flops.device_peak_flops("bfloat16")
    _as_card(monkeypatch, H100)
    with pytest.raises(KeyError, match="float16"):
        flops.mfu(1e12, 1.0, "float16")
    assert all(not name.lower().startswith("tpu")
               for name, _ in flops.PEAK_FLOPS)
