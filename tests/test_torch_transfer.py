"""The port's transfer path against mst_tpu.transfer, on the CPU.

- transfer_styles end to end with the ``snapshots/4900`` weights (the
  committed npz export): every ``.mid`` the port writes must be byte-equal
  to mst_tpu's, or differ only in fp32-boundary cells (mst_torch.parity,
  the rule of tests/test_e2e_reference_parity.py:241-273);
- the packed words and the compaction records: bit-equal to mst_tpu's
  ``_pack_word`` and ``_compact_song`` (the capacity tiers, the pool and
  the ladder: tests/test_torch_fused.py);
- the instrument pick, including the percussion-only top-2 escalation;
- the committed npz equals a fresh restore of ``snapshots/``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu import transfer as jt
from mst_tpu.models import StyleTransferModel as JModel
from mst_torch import transfer as tt
from mst_torch import weights
from mst_torch.data.taxonomy import PERCUSSION_ID
from mst_torch.parity import midi_differences

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _nest(flat):
    out = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return out


@pytest.fixture(scope="module")
def bundles():
    flat = weights.load_npz()
    j_bundle = jt.ModelBundle(model=JModel(), params={"params": _nest(flat)})
    return j_bundle, tt.ModelBundle.from_npz(device="cpu")


def _write_songs(tmp_path, seeds):
    """Synthetic songs from tools/make_corpus.py at the given seeds (all of
    32..64 bars, so the bar bucket is 64)."""
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_tpu.io import create_midi, native

    paths = []
    for seed in seeds:
        info, instruments = generate_song(np.random.default_rng(seed))
        path = str(tmp_path / f"song{seed}.mid")
        native.write_midi_file(path, create_midi(info, *instruments))
        paths.append(path)
    return paths


# seeds: 0 (2 channels, 39 bars, percussion), 245 (2, 48, percussion),
# 250 (2, 43, none) as compositions; 235 (2, 42, percussion) as the style.
# "mixed" puts the songs in two extraction groups (mst_tpu's two-dispatch
# path), "percussion" in one (its fully fused single program).
@pytest.mark.parametrize("comp_seeds", [(0, 250), (0, 245)],
                         ids=["mixed", "percussion"])
def test_transfer_styles_matches_mst_tpu(bundles, tmp_path, comp_seeds):
    j_bundle, t_bundle = bundles
    comps = _write_songs(tmp_path, comp_seeds)
    styles = _write_songs(tmp_path, (235,))
    want = jt.transfer_styles(j_bundle, comps, styles, str(tmp_path / "jax"))
    got = tt.transfer_styles(t_bundle, comps, styles, str(tmp_path / "torch"))
    assert [os.path.relpath(p, tmp_path / "torch") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(got) == 2 * 4
    n_equal = 0
    for a, b in zip(want, got):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            equal, faults, _ = midi_differences(fa.read(), fb.read())
        assert not faults, (os.path.basename(a), faults)
        n_equal += equal
    # the originals decode on the host alone: always byte-equal
    assert n_equal >= 4


def _packed_input(rng, B, C, R, T, N, F):
    """Applier-like outputs with many cells at the hard-output boundaries:
    velocities at the 0.01 gate, accidental ties, durations near ticks."""
    x = rng.random((B, C, R, T, 10, N, F), dtype=np.float32)
    x[..., 0] *= 6.0
    vel = x[..., 1]
    vel[rng.random(vel.shape) < 0.3] = np.float32(0.01)
    vel[rng.random(vel.shape) < 0.5] *= np.float32(0.02)
    if F == 5:
        tie = rng.random(x.shape[:-1]) < 0.1
        x[..., 3][tie] = x[..., 2][tie]
        x[..., 2:][rng.random(x.shape[:-1]) < 0.2] = np.float32(0.1)
    return x


@pytest.mark.parametrize("N,F", [(56, 5), (47, 2)])
def test_pack_word_and_compaction_match(N, F):
    rng = np.random.default_rng(F)
    B, C, R, T = 3, 2, 5, 4
    x = _packed_input(rng, B, C, R, T, N, F)
    tpb = np.array([480.0, 96.0, 1024.0], np.float32)
    n_channels = np.array([2, 1, 0], np.int64)
    n_bars = np.array([5, 3, 1], np.int64)

    want_word = np.asarray(jt._pack_word(
        jnp.asarray(x), jnp.asarray(tpb).reshape(B, 1, 1, 1, 1, 1)))
    got_word = tt._pack_word(torch.from_numpy(x),
                             torch.from_numpy(tpb).reshape(B, 1, 1, 1, 1, 1))
    np.testing.assert_array_equal(got_word.numpy(),
                                  want_word.astype(np.int64))
    assert (want_word != 0).any() and (want_word == 0).any()

    count, live, rec = tt._compact_song(
        got_word, torch.from_numpy(n_channels), torch.from_numpy(n_bars),
        16384, 16384)
    for b in range(B):
        want_count, want_live, want_rec = jt._compact_song(
            jnp.asarray(want_word[b]), int(n_channels[b]), int(n_bars[b]),
            16384, 16384)
        assert int(count[b]) == int(want_count)
        assert int(live[b]) == int(want_live)
        np.testing.assert_array_equal(rec[b].numpy(),
                                      np.asarray(want_rec).astype(np.int64))


def test_pick_instruments_matches():
    """Random logits and instrument counts, plus crafted rows: percussion on
    top with one instrument (the top-2 escalation), percussion on top with
    more, and tied logits (the stable sort keeps the lower index first)."""
    rng = np.random.default_rng(3)
    B = 24
    logits = rng.normal(size=(B, 41)).astype(np.float32)
    n_inst = rng.integers(1, 12, B).astype(np.int32)
    logits[0, PERCUSSION_ID] = 10.0
    n_inst[0] = 1
    logits[1, PERCUSSION_ID] = 10.0
    n_inst[1] = 3
    logits[2, :] = 0.5                                # all tied
    n_inst[2] = 4
    logits[3, [5, 9, PERCUSSION_ID]] = 9.0            # tie with percussion
    n_inst[3] = 1
    n_inst[4] = 11                                    # more than 8 channels
    want = jax.vmap(lambda lg, n: jt._device_pick_instruments(lg, n, 8))(
        jnp.asarray(logits), jnp.asarray(n_inst))
    got = tt._pick_instruments(torch.from_numpy(logits),
                               torch.from_numpy(n_inst.astype(np.int64)), 8)
    for g, w, label in zip(got, want, ("picked", "n_picked",
                                       "has_unpitched")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=label)
    assert int(got[1][0]) == 1 and bool(got[2][0])    # escalated row


def test_committed_npz_equals_snapshot():
    """mst_torch/assets/snapshot_4900.npz is the params of snapshots/4900,
    leaf for leaf (restored from a temporary copy of snapshots/)."""
    sys.path.insert(0, TOOLS)
    from export_torch_assets import restore_snapshot_params

    fresh, step = restore_snapshot_params(
        os.path.join(os.path.dirname(__file__), "..", "snapshots"))
    assert step == 4900
    committed = weights.load_npz()
    assert sorted(committed) == sorted(fresh)
    for key, value in fresh.items():
        assert committed[key].dtype == np.float32
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert sum(v.size for v in committed.values()) == 980325


def test_bf16_extraction_latents_match_mst_tpu(bundles, tmp_path):
    """With extract_storage_dtype="bfloat16" the port's latents track
    mst_tpu's under the same setting: rtol 1e-2, atol 1e-3, the bf16
    policy's tolerance in tests/test_torch_precision.py (the two store the
    same activations at bf16; fp32 sums in other orders can land on the
    two sides of a bf16 rounding boundary). The latents stay fp32, and
    the setting does take effect: they differ from the fp32 extraction's."""
    j_fp32, _ = bundles
    j_bundle = jt.ModelBundle(model=JModel(), params=j_fp32.params,
                              extract_storage_dtype="bfloat16")
    t_bundle = tt.ModelBundle.from_npz(device="cpu",
                                       extract_storage_dtype="bfloat16")
    t_fp32 = bundles[1]
    paths = _write_songs(tmp_path, (0, 245, 250))
    j_songs = [jt.get_model_input(p)[1] for p in paths]
    t_songs = [tt.get_model_input(p)[1] for p in paths]
    want, want_loc = jt.extract_styles(j_bundle, j_songs)
    with torch.inference_mode():
        got, got_loc = tt.extract_styles(t_bundle, t_songs)
        fp32, _ = tt.extract_styles(t_fp32, t_songs)
    assert got_loc == want_loc and len(got) == len(want) == 2
    for g, w, f in zip(got, want, fp32):
        assert g.n_bars == w.n_bars
        for name in ("style", "melody", "rhythm"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2,
                                       atol=1e-3, err_msg=name)
        assert not torch.equal(g.melody, f.melody)


def test_apply_stage_keeps_fp32_storage_under_a_process_policy(bundles,
                                                              tmp_path):
    """A bf16 storage policy set around a request reaches neither stage:
    the apply stage is pinned to fp32 storage and the extraction stage to
    the bundle's own setting, so the files are byte-equal to a request
    made without it."""
    from mst_torch.ops import precision

    _, t_bundle = bundles
    comps = _write_songs(tmp_path, (0,))
    styles = _write_songs(tmp_path, (235,))
    want = tt.transfer_styles(t_bundle, comps, styles, str(tmp_path / "a"))
    with precision.precision("float32", storage="bfloat16"):
        got = tt.transfer_styles(t_bundle, comps, styles,
                                 str(tmp_path / "b"))
    for a, b in zip(want, got):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
