"""The port's training path against mst_tpu's, on the CPU.

Narrow widths (the NARROW config of tests/test_torch_model.py), inputs made
from numpy seeds or tools/make_corpus.py songs, and one JAX compile per
variant in module fixtures. Each test states its tolerance:

- losses and their gradients with respect to the predictions: rtol = atol
  = 1e-5 — both frameworks sum ~10^4-10^5 cells in fp32 in different orders;
- per-leaf gradients of the training loss through the whole model:
  tests/test_fused_tails.py's fp32-reassociation rule (rtol 1e-5, atol
  1e-5 + 2e-6 * max|want|), since the gradient sums over every cell;
- Adam + StepLR over 410 applies: rtol 1e-5, atol 3e-5. optax takes the
  bias corrections in float32 (0.999 rounds to 0.99900001, so 1 - 0.999^t
  is off by up to 1.3e-5 relatively at t = 1) and torch in float64, so
  each update differs by up to ~6.5e-6 relatively, and over 410 updates of
  about lr = 0.01 those differences add to at most ~2.7e-5 on a parameter;
- loss trajectories: rtol 2e-5 on the losses (measured up to 1.9e-6) and
  atol 1e-4 on the parameters after two Adam applies (measured up to
  3.9e-5): Adam's first updates are about lr * sign(grad), so a gradient
  near zero that rounds differently moves its parameter differently;
- rasters, batches, resume and the CLI: exact.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.config import Config as JConfig
from mst_tpu.config import ModelConfig as JModelConfig
from mst_tpu.models import StyleTransferModel as JModel
from mst_tpu.ops import losses as jl
from mst_tpu.runtime import train as jtr
from mst_torch import weights
from mst_torch.config import Config, ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import losses as tl
from mst_torch.runtime import train as ttr
from tests.test_torch_model import NARROW, _params_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# make_corpus seeds: 0, 245 and 235 share beats-per-bar and have
# percussion; 250 has none (tests/test_torch_transfer.py)
PERC_SEEDS = (0, 245, 235)
NO_PERC_SEED = 250


def _assert_close(got, want, label=""):
    """tests/test_fused_tails.py's fp32-reassociation tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 + 2e-6 * np.abs(want).max(),
                               err_msg=label)


# ----------------------------------------------------------------- songs

@pytest.fixture(scope="module")
def songs():
    """{seed: (mst_tpu Song, mst_torch Song)} from one MIDI byte string."""
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_tpu.data.pipeline import get_input as j_get_input
    from mst_tpu.io import create_midi
    from mst_tpu.io import smf as j_smf
    from mst_tpu.ops.events import read_midi as j_read
    from mst_torch.data.pipeline import get_input as t_get_input
    from mst_torch.io import smf as t_smf
    from mst_torch.ops.events import read_midi as t_read

    out = {}
    for seed in PERC_SEEDS + (NO_PERC_SEED,):
        info, instruments = generate_song(np.random.default_rng(seed))
        data = j_smf.encode_midi(create_midi(info, *instruments))
        out[seed] = (j_get_input(*j_read(j_smf.parse_midi_bytes(data))),
                     t_get_input(*t_read(t_smf.parse_midi_bytes(data))))
    return out


def _np(x):
    return None if x is None else np.asarray(x)


def _batch_equal(got, want):
    for name in jtr.Batch._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                err_msg=name)


def _to_jax(batch):
    return jtr.Batch(*(None if t is None else jnp.asarray(t.numpy())
                       for t in batch))


# ------------------------------------------------ (g) rasters and batches

def test_device_rasterize_batch_bit_equal(songs):
    from mst_tpu.ops import device_raster as jdr
    from mst_tpu.ops.rasterize import Rasterizer as JR
    from mst_torch.ops import device_raster as tdr
    from mst_torch.ops.rasterize import Rasterizer as TR

    picked = [songs[s] for s in PERC_SEEDS]
    caps = [12, 8, 12]
    for pitched, n_ch in ((True, 2), (False, 1)):
        def notes(s):
            return (s.pitched_notes if pitched else s.unpitched_notes)[:n_ch]
        want = jdr.device_rasterize_batch(
            [JR(j.info) for j, _ in picked], [notes(j) for j, _ in picked],
            pitched, n_ch, 16, caps, fuse_nf=True)
        got = tdr.device_rasterize_batch(
            [TR(t.info) for _, t in picked], [notes(t) for _, t in picked],
            pitched, n_ch, 16, caps, fuse_nf=True, device="cpu")
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    j, t = songs[0]
    want = jdr.device_rasterize_song(JR(j.info), j.pitched_notes, True, 2)
    got = tdr.device_rasterize_song(TR(t.info), t.pitched_notes, True, 2,
                                    device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seeds", [PERC_SEEDS, (0, NO_PERC_SEED)],
                         ids=["percussion", "mixed"])
def test_batches_bit_equal(songs, seeds):
    """device_batch_from_songs, pad_batch and batch_from_song equal
    mst_tpu's field for field; the device raster equals the host one."""
    j_songs = [songs[s][0] for s in seeds]
    t_songs = [songs[s][1] for s in seeds]
    caps = [10, 6, 12][:len(seeds)]
    dev = ttr.device_batch_from_songs(t_songs, 2, 16, bar_cap=caps,
                                      device="cpu")
    _batch_equal(dev, jtr.device_batch_from_songs(j_songs, 2, 16,
                                                  bar_cap=caps))
    pad = ttr.pad_batch(t_songs, 2, 16, bar_cap=caps, device="cpu")
    _batch_equal(pad, jtr.pad_batch(j_songs, 2, 16, bar_cap=caps))
    _batch_equal(pad, _to_jax(dev))
    one = ttr.batch_from_song(t_songs[0], 9, device="cpu")
    _batch_equal(one, jtr.batch_from_song(j_songs[0], 9))
    assert ttr.device_batch_from_song(t_songs[0], 2, 16, bar_cap=9,
                                      device="cpu").pitched.shape[2] == 16


def test_bucket_helpers():
    for n in (1, 3, 64, 65, 800, 801):
        assert ttr.bucket_shape(n, (64, 128, 256, 512, 800)) == \
            jtr.bucket_shape(n, (64, 128, 256, 512, 800))
    for args in ((256, 8, 8, 4), (128, 8, 8, 4), (800, 1, 2, 4),
                 (512, 4, 16, 3)):
        assert ttr.clamp_bar_bucket(*args, 8 * 8 * 128 * 4,
                                    (64, 128, 256, 512, 800)) == \
            jtr.clamp_bar_bucket(*args, 8 * 8 * 128 * 4,
                                 (64, 128, 256, 512, 800))


# ------------------------------------------------- (h) stream reordering

@pytest.mark.parametrize("stream,k,limit,want", [
    ("AABBBBAB", 2, None, [(1, ["A", "A"]), (3, ["B", "B"]), (5, ["B", "B"]),
                           (6, ["A"]), (7, ["B"])]),
    ("ABABAB", 3, None, [(i, [c]) for i, c in enumerate("ABABAB")]),
    ("AAAAAAA", 3, 5, [(2, ["A"] * 3), (3, ["A"]), (4, ["A"]), (5, ["A"]),
                       (6, ["A"])]),
])
def test_group_stacks_cases(stream, k, limit, want):
    """The cases of tests/test_multi_step.py:107-130, on both packages."""
    pairs = list(enumerate(stream))
    got = list(ttr.group_stacks(iter(pairs), k, lambda x: x, limit=limit))
    assert got == want
    assert got == list(jtr.group_stacks(iter(pairs), k, lambda x: x,
                                        limit=limit))


@pytest.mark.parametrize("stream,window", [
    ("ABABABAB", 8), ("ABABABABABAB", 6), ("ABCABACBAC", 5)])
def test_window_sort_cases(stream, window):
    """The cases of tests/test_multi_step.py:132-165, on both packages."""
    pairs = [(i + 1, s) for i, s in enumerate(stream)]
    got = list(ttr.window_sort(iter(pairs), window, lambda x: x))
    assert got == list(jtr.window_sort(iter(pairs), window, lambda x: x))
    assert sorted(it for _, it in got) == sorted(stream)
    stacks = list(ttr.group_stacks(iter(got), 3, lambda x: x))
    assert sum(len(items) for _, items in stacks) == len(stream)
    if stream == "ABABABABABAB":
        assert all(len(items) == 3 for _, items in stacks)


# ----------------------------------------------------------- (c) losses

def _loss_inputs(rng, percussion):
    B, C, R, T = 2, 3, 4, 2
    f = np.float32

    def raster(shape, density):
        x = rng.random(shape, dtype=f)
        return (x * (rng.random(shape[:-1] + (1,)) < density)).astype(f)

    p_pred = rng.random((B, C, R, T, 10, 56, 5), dtype=f)
    p_pred[..., 0] *= 6
    p_target = raster((B, C, R, T, 10, 56, 5), 0.1)
    p_target[..., 0] *= 7                      # some beyond MAX_DURATION
    # ties: predictions equal to targets (and both 0) at some cells
    tie = rng.random(p_pred.shape[:-1]) < 0.05
    p_pred[..., 1][tie] = p_target[..., 1][tie]
    p_mask = np.ones((B, C, R), f)
    p_mask[1, 2:] = 0.0
    p_mask[0, :, 3] = 0.0
    inst_t = (rng.random((B, 41)) < 0.2).astype(f)
    mode_t = np.array([[1, 0], [0, 1]], f)
    args = dict(
        instruments_pred=rng.normal(size=(B, 41)).astype(f),
        instruments_target=inst_t,
        mode_pred=rng.normal(size=(B, 2)).astype(f), mode_target=mode_t,
        bpm_pred=np.array([110.0, 60.0], f), bpm_target=np.array([96.0, 140.0], f),
        pitched_pred=p_pred, pitched_target=p_target,
        pitched_pad_mask=p_mask)
    if percussion:
        u_target = raster((B, 1, R, T, 10, 47, 2), 0.1)
        args.update(
            unpitched_pred=rng.random((B, 1, R, T, 10, 47, 2), dtype=f),
            unpitched_target=u_target,
            unpitched_pad_mask=np.ones((B, 1, R), f))
    return args


PRED_KEYS = ("instruments_pred", "mode_pred", "bpm_pred", "pitched_pred",
             "unpitched_pred")


@pytest.mark.parametrize("percussion", [True, False])
def test_loss_dict_and_gradients_match(percussion):
    """Every LossDict field, and the gradient of ``total`` with respect to
    every prediction, on a padded batch with masks, ties and durations past
    MAX_DURATION."""
    args = _loss_inputs(np.random.default_rng(int(percussion)), percussion)
    preds = [k for k in PRED_KEYS if k in args]

    def j_total(p):
        kw = dict(args, **p)
        return jl.total_loss(**{k: jnp.asarray(v) for k, v in kw.items()},
                             normalize=True)

    want = jax.jit(j_total)({k: args[k] for k in preds})
    want_grads = jax.jit(jax.grad(lambda p: j_total(p).total))(
        {k: args[k] for k in preds})
    t_args = {k: torch.from_numpy(v) for k, v in args.items()}
    for k in preds:
        t_args[k].requires_grad_(True)
    got = tl.total_loss(**t_args, normalize=True)
    for name, g, w in zip(tl.LossDict._fields, got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), err_msg=name,
                                   equal_nan=True, **LOSS_TOL)
    assert np.isnan(float(got.unpitched_total.detach())) == (not percussion)
    got.total.backward()
    for k in preds:
        np.testing.assert_allclose(t_args[k].grad.numpy(),
                                   np.asarray(want_grads[k]), err_msg=k,
                                   **LOSS_TOL)
    assert (got.as_nested_dict()["channels_loss"]["unpitched"] is None) == \
        (not percussion)


def test_safe_ops_at_zero_and_nan():
    """safe_sqrt: value 0 and gradient 0 at 0, NaN stays NaN with JAX's
    gradient; safe_div nudges near-zero denominators by eps as JAX does."""
    x = np.array([0.0, 4.0, np.nan, -1.0, 1e-12], np.float32)
    jv, jvjp = jax.vjp(jl.safe_sqrt, jnp.asarray(x))
    jg = jvjp(jnp.ones_like(jnp.asarray(x)))[0]
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = tl.safe_sqrt(tx)
    tv.sum().backward()
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    assert tv[0] == 0 and tx.grad[0] == 0 and np.isnan(float(tv[2]))
    d = np.array([0.0, -0.0, 5e-8, -5e-8, 2.0], np.float32)
    np.testing.assert_array_equal(
        tl.safe_div(torch.ones(5), torch.from_numpy(d)).numpy(),
        np.asarray(jl.safe_div(jnp.ones(5), jnp.asarray(d))))
    means = [np.float32(v) for v in (0.25, 0.5)]
    for mt in ("arithmetic", "harmonic", "geometric", "quadratic"):
        np.testing.assert_allclose(
            float(tl.get_mean([torch.tensor(v) for v in means],
                              mean_type=mt)),
            float(jl.get_mean([jnp.asarray(v) for v in means],
                              mean_type=mt)), rtol=1e-6)


def test_hard_output_matches():
    rng = np.random.default_rng(9)
    for F in (5, 2):
        x = rng.random((3, 4, 10, F), dtype=np.float32)
        x[..., 1][rng.random(x.shape[:-1]) < 0.3] = np.float32(0.01)
        if F == 5:
            x[..., 3] = np.where(rng.random(x.shape[:-1]) < 0.3, x[..., 2],
                                 x[..., 3])
        np.testing.assert_array_equal(
            tl.hard_output(torch.from_numpy(x)).numpy(),
            np.asarray(jl.hard_output(jnp.asarray(x))))


# ------------------------------------------ model pair and train states

@pytest.fixture(scope="module")
def model_pair():
    """(mst_tpu model, its flax params, Config pair) at NARROW widths."""
    j_model = JModel(JModelConfig(**NARROW))
    params = _params_like(
        j_model.init, jax.random.PRNGKey(1), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]), jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    j_config = JConfig(model=JModelConfig(**NARROW))
    t_config = Config(model=ModelConfig(**NARROW))
    return j_model, params, j_config, t_config


def _torch_model(params, t_config):
    model = StyleTransferModel(t_config.model)
    model.load_state_dict(weights.state_dict_from_flax(params), strict=True)
    return model


def _flax_to_torch(tree):
    return weights.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               tree))


# -------------------------------------------- (d) per-leaf gradients

@pytest.mark.parametrize("seeds", [(0, 245), (NO_PERC_SEED, 0)],
                         ids=["percussion", "mixed"])
def test_loss_fn_per_leaf_gradients(songs, model_pair, seeds):
    """loss_fn's value and every leaf's gradient from shared flax params,
    on device-built batches of two songs. ``mixed``: the first song has no
    percussion, so its row of the percussion branch is masked out."""
    j_model, params, _, t_config = model_pair
    j_songs = [songs[s][0] for s in seeds]
    t_songs = [songs[s][1] for s in seeds]
    j_batch = jtr.device_batch_from_songs(j_songs, 2, 8, bar_cap=[8, 6])
    t_batch = ttr.device_batch_from_songs(t_songs, 2, 8, bar_cap=[8, 6],
                                          device="cpu")
    has_u = t_batch.unpitched is not None
    (want, want_l), want_g = jax.jit(jax.value_and_grad(
        lambda p: (lambda l: (l.total, l))(
            jtr.loss_fn(j_model, p, j_batch, has_u)),
        has_aux=True))(params)
    model = _torch_model(params, t_config)
    losses = ttr.loss_fn(model, t_batch, has_u)
    losses.total.backward()
    for name, g, w in zip(tl.LossDict._fields, losses, want_l):
        np.testing.assert_allclose(float(g.detach()), float(w), err_msg=name,
                                   equal_nan=True, **LOSS_TOL)
    want_t = _flax_to_torch(want_g)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        _assert_close(g.numpy(), want_t[name].numpy(), name)


def test_loss_fn_no_percussion_song(songs, model_pair):
    """One song without percussion: the unpitched branch gets no gradient
    in the port (None) and zeros in mst_tpu."""
    j_model, params, _, t_config = model_pair
    j_song, t_song = songs[NO_PERC_SEED]
    j_batch = jtr.device_batch_from_songs([j_song], 2, 8, bar_cap=8)
    t_batch = ttr.device_batch_from_songs([t_song], 2, 8, bar_cap=8,
                                          device="cpu")
    assert t_batch.unpitched is None
    want_g = jax.jit(jax.grad(
        lambda p: jtr.loss_fn(j_model, p, j_batch, False).total))(params)
    model = _torch_model(params, t_config)
    ttr.loss_fn(model, t_batch, False).total.backward()
    want_t = _flax_to_torch(want_g)
    for name, p in model.named_parameters():
        if name.startswith(("unpitched_channels", "unpitched_rhythm",
                            "unpitched_style")):
            assert p.grad is None and not want_t[name].any(), name
        else:
            _assert_close(p.grad.numpy(), want_t[name].numpy(), name)


# ------------------------------------------------ (e) Adam + StepLR

def test_adam_steplr_matches_optax_over_410_applies():
    """One gradient sequence through optax (mst_tpu's make_optimizer) and
    the port's optimizer, across the StepLR decays at 200 and 400 applies.
    Leaf ``b`` has no gradient on every third apply: None in torch, zeros
    in optax, which still moves it through its moments."""
    import optax

    rng = np.random.default_rng(5)
    n = 410
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 2)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(n)]
    absent = [i % 3 == 2 for i in range(n)]

    opt = jtr.make_optimizer(JConfig())
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = opt.init(j_params)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    optimizer, scheduler = ttr.make_optimizer(module, Config())
    state = ttr.TrainState(model=module, optimizer=optimizer,
                           scheduler=scheduler)
    for i in range(n):
        g = dict(grads[i])
        if absent[i]:
            g["b"] = np.zeros_like(g["b"])
        upd, j_state = update({k: jnp.asarray(v) for k, v in g.items()},
                              j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        module.a.grad = torch.from_numpy(grads[i]["a"].copy())
        module.b.grad = (None if absent[i]
                         else torch.from_numpy(grads[i]["b"].copy()))
        ttr.apply_updates(state)
        if i + 1 in (1, 199, 200, 201, 400, 401, 410):
            for k in shapes:
                np.testing.assert_allclose(
                    getattr(module, k).detach().numpy(),
                    np.asarray(j_params[k]), rtol=1e-5, atol=3e-5,
                    err_msg=f"{k} after {i + 1} applies")
    assert state.opt_step == n
    assert optimizer.param_groups[0]["lr"] == pytest.approx(0.01 * 0.9 ** 2)
    # the apply clears the gradient buffers in place, never to None
    assert not module.a.grad.any() and not module.b.grad.any()


# ------------------------------------------------ (f) trajectories

@pytest.fixture(scope="module")
def trajectory(songs, model_pair):
    """mst_tpu's 4-micro-step run on the percussion songs: the batches,
    the per-step loss vectors, and the numpy train state after 2 steps."""
    j_model, params, j_config, _ = model_pair
    order = PERC_SEEDS + (PERC_SEEDS[0],)
    caps = (8, 6, 7, 5)
    j_batches = [jtr.device_batch_from_songs([songs[s][0]], 2, 8, bar_cap=c)
                 for s, c in zip(order, caps)]
    t_batches = [ttr.device_batch_from_songs([songs[s][1]], 2, 8, bar_cap=c,
                                             device="cpu")
                 for s, c in zip(order, caps)]
    opt = jtr.make_optimizer(j_config)
    params = jax.tree_util.tree_map(jnp.array, params)  # the step donates it
    state = jtr.TrainState(
        params=params, opt_state=opt.init(params),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, params),
        micro_step=jnp.zeros((), jnp.int32), opt_step=jnp.zeros((), jnp.int32))
    step = jtr.make_train_step(j_model, j_config, True, fetch_losses=False)
    losses, mid = [], None
    for i, b in enumerate(j_batches):
        state, vec = step(state, b)
        losses.append(np.asarray(vec))
        if i == 1:
            mid = jax.tree_util.tree_map(np.asarray, state)
    final = jax.tree_util.tree_map(np.asarray, state.params)
    return t_batches, np.stack(losses), mid, final


def test_four_step_trajectory_matches(trajectory, model_pair):
    j_model, params, _, t_config = model_pair
    t_batches, want, _, final = trajectory
    state = ttr.create_train_state(t_config, device="cpu",
                                   model=_torch_model(params, t_config))
    step = ttr.make_train_step(t_config, True)
    got = np.stack([step(state, b)[1].numpy() for b in t_batches])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    assert (state.micro_step, state.opt_step) == (4, 2)
    want_t = weights.state_dict_from_flax(final)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_t[name].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


def test_resume_from_mst_tpu_state(trajectory, model_pair):
    """mst_tpu 2 steps -> train_state_from_flax -> port 2 steps equals
    mst_tpu 4 steps; the multi-step call equals the single steps."""
    _, _, _, t_config = model_pair
    t_batches, want, mid, _ = trajectory
    adam = mid.opt_state[0]
    state = weights.train_state_from_flax(
        mid.params, adam.mu, adam.nu, int(adam.count), mid.accum_grads,
        int(mid.micro_step), int(mid.opt_step), config=t_config,
        device="cpu")
    assert (state.micro_step, state.opt_step) == (2, 1)
    multi = ttr.make_multi_train_step(t_config, True, 2)
    stacked = ttr.Batch(*(None if f[0] is None else torch.cat(f)
                          for f in zip(*t_batches[2:])))
    _, got = multi(state, stacked)
    np.testing.assert_allclose(got.numpy(), want[2:], rtol=2e-5, atol=1e-7)
    assert (state.micro_step, state.opt_step) == (4, 2)


def test_train_state_from_flax_defaults_to_cuda_and_raises_without_it(
        monkeypatch):
    """Without a device, the carried-over state goes to the GPU; a host
    without one gets an error, never a state on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.train_state_from_flax({}, {}, {}, 0, {}, 0, 0)


# -------------------------------------- (i) the CLI and its resume

def _cli():
    spec = importlib.util.spec_from_file_location(
        "train_model_torch", os.path.join(ROOT, "train-model-torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _csv_rows(path):
    import csv
    with open(path) as fh:
        return [{k: v for k, v in row.items()} for row in csv.DictReader(fh)]


def _cli_runner(tmp_path):
    """train-model-torch.py --device cpu on 3 synthetic songs:
    ``run(name, iters, resume=False)`` trains into ``tmp_path/name``."""
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_tpu.io import create_midi, native

    data = tmp_path / "data"
    data.mkdir()
    for seed in (0, 245, NO_PERC_SEED):
        info, instruments = generate_song(np.random.default_rng(seed))
        native.write_midi_file(str(data / f"s{seed}.mid"),
                               create_midi(info, *instruments))
    cli = _cli()

    def run(name, iters, resume=False):
        args = ["--data", str(data), "--device", "cpu", "--iters",
                str(iters), "--save-interval", "2", "--csv",
                str(tmp_path / f"{name}.csv"), "--snapshots",
                str(tmp_path / name), "--seed", "3"]
        return cli.main(args + (["--resume"] if resume else []))
    return run


def _assert_resumed_equals_full(tmp_path, resumed):
    """The "split" run (4 iterations, then --resume to 6) against the
    uninterrupted "full" run of 6: the same loss rows and snapshot."""
    assert (resumed.micro_step, resumed.opt_step) == (6, 3)
    full = _csv_rows(tmp_path / "full.csv")
    split = _csv_rows(tmp_path / "split.csv")
    assert [r["iteration"] for r in full] == [str(i) for i in range(6)]
    # the first run logged 0..3, the resumed one 3..5 (from snapshot 2)
    assert [r["iteration"] for r in split] == ["0", "1", "2", "3", "3", "4",
                                               "5"]
    assert split[:4] == full[:4]
    assert split[4:] == full[3:]
    from mst_torch.runtime.checkpoint import CheckpointManager
    a = CheckpointManager(str(tmp_path / "full")).load(4)
    b = CheckpointManager(str(tmp_path / "split")).load(4)
    for name, value in a["model"].items():
        assert torch.equal(value, b["model"][name]), name
    for name, value in a["accum_grads"].items():
        assert torch.equal(value, b["accum_grads"][name]), name
    assert CheckpointManager(str(tmp_path / "full")).load_cursor(4) == \
        CheckpointManager(str(tmp_path / "split")).load_cursor(4)


def test_cli_resume_equals_uninterrupted(tmp_path):
    """train-model-torch.py --device cpu on 3 synthetic songs: 4 iterations
    then --resume to 6 gives the losses and snapshot of an uninterrupted
    run of 6, exactly."""
    run = _cli_runner(tmp_path)
    run("full", 6)
    run("split", 4)
    _assert_resumed_equals_full(tmp_path, run("split", 6, resume=True))


def _step_lr_state(opt_step, step_size=200, gamma=0.9):
    """The state of a ``StepLR(step_size, gamma)`` stepped ``opt_step``
    times, the scheduler state that checkpoints of the StepLR optimizer
    hold."""
    from torch.optim.lr_scheduler import StepLR

    optimizer = torch.optim.Adam([torch.zeros(1)], lr=0.01)
    scheduler = StepLR(optimizer, step_size=step_size, gamma=gamma)
    for _ in range(opt_step):
        optimizer.step()
        scheduler.step()
    return scheduler.state_dict(), optimizer.param_groups[0]["lr"]


def test_cli_resume_of_a_steplr_checkpoint(tmp_path):
    """A checkpoint whose scheduler state is StepLR(200, 0.9)'s resumes
    through --resume: the losses and snapshot of an uninterrupted run,
    exactly."""
    from mst_torch.runtime.checkpoint import CheckpointManager

    run = _cli_runner(tmp_path)
    run("full", 6)
    run("split", 4)
    mgr = CheckpointManager(str(tmp_path / "split"))
    step = mgr.latest_step()
    saved = mgr.load(step)
    saved["scheduler"], _ = _step_lr_state(saved["opt_step"])
    assert "lr_lambdas" not in saved["scheduler"]
    torch.save(saved, os.path.join(mgr.directory, f"ckpt_{step}.pt"))
    _assert_resumed_equals_full(tmp_path, run("split", 6, resume=True))


@pytest.mark.parametrize("case", ["resumes", "unknown kind", "other step",
                                  "other decay"])
def test_steplr_state_takes_the_schedule_rate(model_pair, case):
    """A StepLR state saved at optimizer step 5 of a schedule that decays
    every 2 steps: the resumed state's rate is the schedule's at step 5,
    and one more apply gives the uninterrupted run's parameters and rate,
    exactly. A scheduler state of another kind, another step count or
    another decay raises."""
    import dataclasses

    from torch.optim.lr_scheduler import CosineAnnealingLR

    from mst_torch.runtime.checkpoint import (load_state_dict_into,
                                              state_dict_of)

    _, params, _, t_config = model_pair
    config = dataclasses.replace(t_config, train=dataclasses.replace(
        t_config.train, lr_decay_every=2))

    def state():
        return ttr.create_train_state(config, device="cpu",
                                      model=_torch_model(params, config))

    def apply(s):
        for p in s.model.parameters():
            p.grad = torch.full_like(p, 0.5)
        ttr.apply_updates(s)

    full = state()
    for _ in range(5):
        apply(full)
    saved = state_dict_of(full)
    saved["scheduler"], lr = _step_lr_state(
        4 if case == "other step" else 5,
        step_size=3 if case == "other decay" else 2)
    for group in saved["optimizer"]["param_groups"]:
        group["lr"] = lr               # the rate StepLR left in the groups
    if case == "unknown kind":
        optimizer = torch.optim.Adam([torch.zeros(1)], lr=0.01)
        saved["scheduler"] = CosineAnnealingLR(optimizer, 10).state_dict()
    resumed = state()
    if case != "resumes":
        with pytest.raises(ValueError):
            load_state_dict_into(resumed, saved)
        return
    load_state_dict_into(resumed, saved)
    schedule = ttr.make_lr_schedule(config)
    assert resumed.scheduler.last_epoch == 5
    assert [g["lr"] for g in resumed.optimizer.param_groups] == \
        [g["lr"] for g in full.optimizer.param_groups]
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        schedule(5), rel=1e-12)
    apply(full)
    apply(resumed)
    for (name, a), b in zip(full.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    assert resumed.scheduler.get_last_lr() == full.scheduler.get_last_lr()
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        schedule(6), rel=1e-12)


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.mid").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli().main(["--data", str(tmp_path), "--iters", "1"])


def test_training_backends_are_fp32_and_deterministic(monkeypatch):
    """Training turns TF32 off and cuDNN's nondeterministic algorithms off,
    so a resumed run on the card reproduces the uninterrupted one."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ttr.reproducible_backends()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------- checkpoints and model bundles

def test_checkpoint_roundtrip_and_bundle(tmp_path, model_pair):
    from mst_torch.runtime.checkpoint import CheckpointManager
    from mst_torch.transfer import ModelBundle

    _, params, _, t_config = model_pair
    state = ttr.create_train_state(t_config, device="cpu",
                                   model=_torch_model(params, t_config))
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 0.5)
    ttr.apply_updates(state)
    next(state.model.parameters()).grad = torch.ones(1).expand_as(
        next(state.model.parameters())).clone()
    state.micro_step = 3
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state, cursor=10 * step)
    assert mgr.steps() == [2, 3] and mgr.load_cursor(3) == 30
    assert mgr.load_cursor(1) is None

    fresh = ttr.create_train_state(t_config, device="cpu", seed=4)
    mgr.restore(fresh)
    assert (fresh.micro_step, fresh.opt_step) == (3, 1)
    for (name, a), b in zip(state.model.named_parameters(),
                            fresh.model.parameters()):
        assert torch.equal(a, b), name
        want = a.grad if a.grad is not None else torch.zeros_like(a)
        assert torch.equal(b.grad, want), name
    assert fresh.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()
    assert fresh.scheduler.last_epoch == 1

    bundle = ModelBundle.from_checkpoint(str(tmp_path / "ck"), device="cpu",
                                         config=t_config.model)
    for (name, a), b in zip(state.model.named_parameters(),
                            bundle.model.parameters()):
        assert torch.equal(a, b), name
    with pytest.raises(FileNotFoundError):
        ModelBundle.from_checkpoint(str(tmp_path / "none"), device="cpu")


# ------------------------------------------------ (j) fresh init

def test_fresh_init_bounds_per_leaf(model_pair):
    """init_parameters draws every leaf from mst_tpu's distribution: inside
    its U(+-bound) (1/sqrt(fan_in) for linears and the conv, 1/sqrt(H) for
    LSTMs), spread across it, and mst_tpu's own init lies inside the same
    bounds. The same seed gives the same model; another seed another."""
    j_model, _, _, t_config = model_pair
    model = StyleTransferModel(t_config.model).init_parameters(108)
    bounds = {}
    for mod_name, module in model.named_modules():
        if hasattr(module, "reset_parameters") and module is not model:
            if hasattr(module, "features"):          # LSTM / BiLSTM
                b = 1.0 / np.sqrt(module.features)
            elif module.weight.dim() == 3:            # Conv1d
                b = 1.0 / np.sqrt(module.weight.shape[1]
                                  * module.weight.shape[2])
            else:
                b = 1.0 / np.sqrt(module.weight.shape[1])
            for leaf, _ in module.named_parameters():
                bounds[f"{mod_name}.{leaf}"] = b
    params = dict(model.named_parameters())
    assert sorted(bounds) == sorted(params)
    for name, p in params.items():
        v = p.detach().numpy()
        assert np.abs(v).max() <= bounds[name], name
        if v.size >= 64:
            assert np.abs(v).max() > 0.8 * bounds[name], name
            assert abs(v.std() - bounds[name] / np.sqrt(3)) < \
                0.25 * bounds[name], name
    j_params = jax.jit(j_model.init)(
        jax.random.PRNGKey(108), jnp.array([[1.0, 0.0]]), jnp.array([120.0]),
        jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    j_sd = _flax_to_torch(j_params)
    assert sorted(j_sd) == sorted(params)
    for name, value in j_sd.items():
        assert np.abs(value.numpy()).max() <= bounds[name] * (1 + 1e-6), name
    again = StyleTransferModel(t_config.model).init_parameters(108)
    other = StyleTransferModel(t_config.model).init_parameters(109)
    for (name, a), b, c in zip(model.named_parameters(), again.parameters(),
                               other.parameters()):
        assert torch.equal(a, b) and not torch.equal(a, c), name
