"""The port's model modules against their flax counterparts, on the CPU.

Each module is built in both frameworks with the same widths; the flax
params (a fresh init) go through ``mst_torch.weights.state_dict_from_flax``
into the torch module, and the same inputs (numpy, from a seed) go through
both. Tolerance: fp32 rtol = atol = 1e-5 on every latent and output — the
two frameworks sum in different orders inside the LSTM recurrences, the
conv and the matmuls, so results agree to a few fp32 ulps, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.config import ModelConfig as JConfig
from mst_tpu.models import encoders as je
from mst_tpu.models import appliers as ja
from mst_tpu.models.layers import ConcatDense as JConcatDense
from mst_tpu.models.layers import Conv1d as JConv1d
from mst_tpu.models.song_info import SongInfoModel as JSongInfo
from mst_tpu.models.style_transfer import StyleTransferModel as JModel
from mst_tpu.ops import lstm as jlstm
from mst_tpu.ops import shapes as jshapes
from mst_torch.config import ModelConfig
from mst_torch.models import appliers as ta
from mst_torch.models import encoders as te
from mst_torch.models.layers import ConcatDense, Conv1d
from mst_torch.models.song_info import SongInfoModel
from mst_torch.models.style_transfer import StyleTransferModel
from mst_torch.ops import lstm as tlstm
from mst_torch.ops import shapes as tshapes
from mst_torch.weights import state_dict_from_flax

TOL = dict(rtol=1e-5, atol=1e-5)
NARROW = dict(beat_size=16, bar_size=16, style_size=32, melody_size=8,
              rhythm_size=16, n_rhythm_features=4)
DEFAULT = {}


def _close(got, want, label=""):
    if isinstance(got, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{label}[{i}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=label, **TOL)


def _convert(x, fn):
    if x is None:
        return None
    if isinstance(x, list):
        return [_convert(a, fn) for a in x]
    return fn(np.array(x))


def _params_like(init, *args, **kwargs):
    """Random params of the tree ``init`` would make (shapes from
    jax.eval_shape, nothing compiled), uniform in +-1/sqrt(fan_in) as the
    torch-default init draws them."""
    rng = np.random.default_rng(11)

    def leaf(s):
        fan_in = s.shape[0] if len(s.shape) == 2 else np.prod(s.shape[1:])
        bound = 1.0 / np.sqrt(fan_in) if len(s.shape) > 1 else 0.1
        return jnp.asarray(rng.uniform(-bound, bound, s.shape), jnp.float32)

    return jax.tree_util.tree_map(leaf, jax.eval_shape(init, *args,
                                                       **kwargs))


def _pair(jmod, tmod, *args, **kwargs):
    """Init ``jmod`` on the numpy inputs, load its params into ``tmod``,
    and return (torch outputs, jax outputs)."""
    j_args = [_convert(a, jnp.asarray) for a in args]
    j_kwargs = {k: _convert(v, jnp.asarray) for k, v in kwargs.items()}
    params = _params_like(jmod.init, jax.random.PRNGKey(0), *j_args,
                          **j_kwargs)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    # jitted: one compile per module, not one per eager op
    want = jax.jit(jmod.apply)(params, *j_args, **j_kwargs)
    with torch.no_grad():
        got = tmod(*[_convert(a, torch.from_numpy) for a in args],
                   **{k: _convert(v, torch.from_numpy)
                      for k, v in kwargs.items()})
    return got, want


def _raster(rng, shape, density=0.1):
    x = rng.random(shape, dtype=np.float32)
    x *= rng.random(shape[:-1] + (1,)) < density
    return x.astype(np.float32)


def _instf(rng, B, C):
    x = np.zeros((B, C, 51), np.float32)
    for c in range(C):
        x[:, c, c] = 1.0
        x[:, c, 40 + c % 11] = 1.0
    return x


def _masks(B, C, R):
    """A padded batch: row 0 full, row 1 with one channel and R-2 bars."""
    cmask = np.ones((B, C), np.float32)
    cmask[1, 1:] = 0.0
    lengths = np.full((B,), R, np.int32)
    lengths[1] = R - 2
    return cmask, lengths


# --------------------------------------------------------------- layers/ops

def test_concat_dense_and_conv():
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=s).astype(np.float32)
             for s in ((2, 1, 1, 5), (2, 1, 4, 3), (2, 3, 1, 2))]
    got, want = _pair(JConcatDense(7), ConcatDense((5, 3, 2), 7), parts)
    _close(got, want)
    x = rng.normal(size=(6, 50, 56)).astype(np.float32)
    got, want = _pair(JConv1d(9, kernel_size=14, stride=7, padding=4),
                      Conv1d(50, 9, 14, 7, 4), x)
    assert tuple(got.shape) == (6, 9, 8)
    _close(got, want)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_lstm_and_bilstm(with_lengths):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 9, 6)).astype(np.float32)
    lengths = np.array([9, 4, 1], np.int32) if with_lengths else None
    got, want = _pair(jlstm.LSTM(5), tlstm.LSTM(6, 5), x, lengths)
    _close(got, want, "lstm")
    got, want = _pair(jlstm.BiLSTM(5), tlstm.BiLSTM(6, 5), x, lengths)
    _close(got, want, "bilstm")


def test_shape_ops():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    lengths = np.array([4, 2], np.int32)
    t = torch.from_numpy
    _close(tshapes.combine(t(x), 1), jshapes.combine(jnp.asarray(x), 1))
    _close(tshapes.combine(t(x), 1, mask=t(mask)),
           jshapes.combine(jnp.asarray(x), 1, mask=jnp.asarray(mask)))
    y = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    b_mask = np.array([True, False])
    _close(tshapes.combine_pair(t(x), t(y), t(b_mask)),
           jshapes.combine_pair(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(b_mask)))
    x2 = x.transpose(0, 2, 1, 3)                      # (B, T=4, ...)
    np.testing.assert_array_equal(
        tshapes.masked_last(t(x2), t(lengths)).numpy(),
        np.asarray(jshapes.masked_last(jnp.asarray(x2),
                                       jnp.asarray(lengths))))
    np.testing.assert_array_equal(
        tshapes.masked_flip(t(x2), t(lengths)).numpy(),
        np.asarray(jshapes.masked_flip(jnp.asarray(x2),
                                       jnp.asarray(lengths))))
    nf = rng.normal(size=(1, 2, 3, 4, 10, 280)).astype(np.float32)
    np.testing.assert_array_equal(
        tshapes.split_note_features(t(nf), 5).numpy(),
        np.asarray(jshapes.split_note_features(jnp.asarray(nf), 5)))


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize("widths", [NARROW, DEFAULT], ids=["narrow",
                                                           "default"])
def test_encoders_and_appliers(widths):
    """Every submodule on a padded batch (bar_lengths, channel masks)."""
    c = ModelConfig(**widths)
    rng = np.random.default_rng(3)
    B, C, R, T = 2, 3, 5, 4
    pitched = _raster(rng, (B, C, R, T, 10, 56, 5))
    unpitched = _raster(rng, (B, 1, R, T, 10, 47, 2))
    instf = _instf(rng, B, C)
    mode = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    bpm = np.array([120.0, 87.0], np.float32)
    cmask, lengths = _masks(B, C, R)
    umask = np.ones((B, 1), np.float32)

    (beats, bars), want = _pair(
        je.PitchedChannelsEncoder(c.beat_size, c.bar_size),
        te.PitchedChannelsEncoder(c.beat_size, c.bar_size),
        pitched, instf, bar_lengths=lengths, channel_mask=cmask)
    _close((beats, bars), want, "pitched channels")
    j_beats, j_bars = (np.asarray(a) for a in want)

    got, want = _pair(je.UnpitchedChannelsEncoder(c.beat_size, c.bar_size),
                      te.UnpitchedChannelsEncoder(c.beat_size, c.bar_size),
                      unpitched, bar_lengths=lengths, channel_mask=umask)
    _close(got, want, "unpitched channels")
    u_beats, u_bars = (np.asarray(a) for a in want)

    got, want = _pair(je.StyleEncoder(c.style_size, c.bar_size),
                      te.StyleEncoder(c.style_size, c.bar_size),
                      j_bars, instf, mode, bpm, bar_lengths=lengths,
                      channel_mask=cmask)
    _close(got, want, "style")
    style = np.asarray(want)

    got, want = _pair(
        je.MelodyEncoder(c.melody_size, c.beat_size, c.bar_size),
        te.MelodyEncoder(c.melody_size, c.beat_size, c.bar_size),
        j_beats, j_bars, pitched, instf, channel_mask=cmask)
    _close(got, want, "melody")
    melody = np.asarray(want)

    got, want = _pair(
        je.PitchedRhythmEncoder(c.rhythm_size, c.beat_size, c.bar_size),
        te.PitchedRhythmEncoder(c.rhythm_size, c.beat_size, c.bar_size),
        j_beats, j_bars, pitched, instf, mode, bpm, channel_mask=cmask)
    _close(got, want, "pitched rhythm")
    rhythm = np.asarray(want)

    got, want = _pair(
        je.UnpitchedRhythmEncoder(c.rhythm_size, c.beat_size, c.bar_size),
        te.UnpitchedRhythmEncoder(c.rhythm_size, c.beat_size, c.bar_size),
        u_beats, u_bars, unpitched, bpm, channel_mask=umask)
    _close(got, want, "unpitched rhythm")

    got, want = _pair(
        JSongInfo(c.n_rhythm_features, c.style_size, c.rhythm_size, 41),
        SongInfoModel(c.n_rhythm_features, c.style_size, c.rhythm_size, 41),
        style, rhythm, bar_lengths=lengths)
    _close(got, want, "song info")

    got, want = _pair(
        ja.PitchedStyleApplier(c.style_size, c.melody_size, c.rhythm_size),
        ta.PitchedStyleApplier(c.style_size, c.melody_size, c.rhythm_size),
        style, melody, rhythm, instf)
    assert tuple(got.shape) == (B, C, R, T, 10, 56, 5)
    _close(got, want, "pitched applier")

    got, want = _pair(ja.UnpitchedStyleApplier(c.style_size, c.rhythm_size),
                      ta.UnpitchedStyleApplier(c.style_size, c.rhythm_size),
                      style, rhythm)
    assert tuple(got.shape) == (B, 1, R, T, 10, 47, 2)
    _close(got, want, "unpitched applier")


def _model_pair(widths):
    j_model = JModel(JConfig(**widths))
    t_model = StyleTransferModel(ModelConfig(**widths))
    params = _params_like(
        j_model.init, jax.random.PRNGKey(1), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]),
        jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    t_model.load_state_dict(state_dict_from_flax(params), strict=True)
    return j_model, params, t_model.eval()


@pytest.mark.parametrize("widths,percussion,nf_fused", [
    (NARROW, "none", False), (NARROW, "all", False), (NARROW, "mixed", True),
    (DEFAULT, "none", True), (DEFAULT, "all", True),
    (DEFAULT, "mixed", False)],
    ids=["narrow-none-7axis", "narrow-all-7axis", "narrow-mixed-fused",
         "default-none-fused", "default-all-fused", "default-mixed-7axis"])
def test_full_model(widths, percussion, nf_fused):
    """extract_style / predict_song_info / apply_style of the whole model on
    a padded batch; rasters 7-axis or NF-fused; songs with and without
    percussion (``mixed``: row 1 has none, masked by uchannel_mask)."""
    j_model, params, t_model = _model_pair(widths)
    rng = np.random.default_rng(4)
    B, C, R, T = 2, 3, 4, 4
    pitched = _raster(rng, (B, C, R, T, 10, 56, 5))
    unpitched = _raster(rng, (B, 1, R, T, 10, 47, 2))
    if nf_fused:
        pitched = pitched.reshape(B, C, R, T, 10, 280)
        unpitched = unpitched.reshape(B, 1, R, T, 10, 94)
    instf = _instf(rng, B, C)
    mode = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    bpm = np.array([96.0, 140.0], np.float32)
    cmask, lengths = _masks(B, C, R)
    umask = None
    if percussion == "none":
        unpitched = None
    elif percussion == "mixed":
        umask = np.array([[1.0], [0.0]], np.float32)
    args = (mode, bpm, pitched, instf, unpitched)
    kwargs = dict(bar_lengths=lengths, channel_mask=cmask,
                  uchannel_mask=umask)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    def run(method, *a, **kw):
        return jax.jit(lambda *a, **kw: j_model.apply(
            params, *a, method=method, **kw))(*a, **kw)

    want = run(JModel.extract_style, *map(j, args),
               **{k: j(v) for k, v in kwargs.items()})
    with torch.no_grad():
        got = t_model.extract_style(*map(t, args),
                                    **{k: t(v) for k, v in kwargs.items()})
        _close(got, want, "extract_style")
        style, melody, rhythm = (np.asarray(a) for a in want)
        want = run(JModel.predict_song_info, j(style), j(rhythm),
                   j(lengths))
        got = t_model.predict_song_info(t(style), t(rhythm), t(lengths))
        _close(got, want, "predict_song_info")
        want = jax.jit(lambda *a: j_model.apply(
            params, *a, True, method=JModel.apply_style))(
                j(style), j(melody), j(rhythm), j(instf))
        got = t_model.apply_style(t(style), t(melody), t(rhythm), t(instf),
                                  True)
        _close(got, want, "apply_style")


def _torch_lstm_param_count(d, h, bidirectional=False):
    per_dir = 4 * h * (d + h) + 8 * h
    return per_dir * (2 if bidirectional else 1)


def _linear(i, o):
    return (i + 1) * o


def test_param_count_matches_reference_architecture():
    """Per-submodule parameter counts equal tests/test_model.py's reference
    layer sizes (980,325 in all)."""
    model = StyleTransferModel()
    expected = {
        "pitched_channels_encoder": (
            (50 * 14 + 1) * 57 + _linear(51, 58) + _linear(514, 64)
            + _torch_lstm_param_count(64, 64)
            + _torch_lstm_param_count(64, 64, bidirectional=True)),
        "unpitched_channels_encoder": (
            _linear(940, 64) + _torch_lstm_param_count(64, 64)
            + _torch_lstm_param_count(64, 64, bidirectional=True)),
        "style_encoder": (
            _torch_lstm_param_count(128, 192) + _linear(51, 39)
            + _linear(2, 13) + _linear(1, 7) + _linear(251, 256)),
        "melody_encoder": (
            _linear(64, 36) + _linear(128, 68) + _linear(51, 8)
            + _linear(112, 64) + _linear(112, 56) + _linear(5, 7)
            + _linear(15, 8)),
        "pitched_rhythm_encoder": (
            _linear(64, 48) + _linear(128, 40) + _linear(280, 16)
            + _linear(51, 21) + _linear(2, 5) + _linear(1, 5)
            + _linear(135, 32)),
        "unpitched_rhythm_encoder": (
            _linear(64, 48) + _linear(128, 40) + _linear(94, 16)
            + _linear(1, 5) + _linear(109, 32)),
        "song_info_model": (
            _torch_lstm_param_count(320, 9) + _torch_lstm_param_count(9, 8)
            + _linear(256, 8) + _linear(8, 10) + _linear(18, 41)
            + _linear(256, 2) + _linear(8, 2) + _linear(4, 2)
            + _linear(256, 2) + _linear(8, 2) + _linear(4, 1)),
        "pitched_style_applier": (
            _linear(256, 66) + _linear(32, 10) + _linear(51, 12)
            + _linear(88, 240) + _linear(88, 210) + _linear(8, 20)
            + _linear(50, 5)),
        "unpitched_style_applier": (
            _linear(256, 650) + _linear(32, 17) + _linear(82, 376)
            + _linear(8, 2)),
    }
    for name, want in expected.items():
        got = sum(p.numel() for p in getattr(model, name).parameters())
        assert got == want, (name, got, want)
    assert sum(p.numel() for p in model.parameters()) == 980325


def test_state_dict_mapping_rules():
    """Dense kernels and LSTM weights transpose, conv kernels and biases
    map as they are, LSTM biases stay two vectors, bwd -> _reverse."""
    rng = np.random.default_rng(5)
    tree = {"enc": {
        "linear": {"kernel": rng.normal(size=(4, 3)),
                   "bias": rng.normal(size=(3,))},
        "beats_conv": {"kernel": rng.normal(size=(3, 2, 5)),
                       "bias": rng.normal(size=(3,))},
        "bars_lstm": {"bwd": {"w_ih": rng.normal(size=(4, 8)),
                              "w_hh": rng.normal(size=(2, 8)),
                              "b_ih": rng.normal(size=(8,)),
                              "b_hh": rng.normal(size=(8,))}},
        "beats_lstm": {"cell": {"w_ih": rng.normal(size=(4, 8))}}}}
    sd = state_dict_from_flax({"params": tree})
    e = tree["enc"]
    np.testing.assert_array_equal(sd["enc.linear.weight"],
                                  np.float32(e["linear"]["kernel"].T))
    np.testing.assert_array_equal(sd["enc.beats_conv.weight"],
                                  np.float32(e["beats_conv"]["kernel"]))
    np.testing.assert_array_equal(
        sd["enc.bars_lstm.weight_hh_l0_reverse"],
        np.float32(e["bars_lstm"]["bwd"]["w_hh"].T))
    np.testing.assert_array_equal(sd["enc.bars_lstm.bias_hh_l0_reverse"],
                                  np.float32(e["bars_lstm"]["bwd"]["b_hh"]))
    np.testing.assert_array_equal(sd["enc.beats_lstm.weight_ih_l0"],
                                  np.float32(e["beats_lstm"]["cell"]["w_ih"].T))
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert len(sd) == 9
