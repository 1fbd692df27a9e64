"""The port's bar-sharded model (``--seq-parallel``) against mst_tpu, on the
CPU.

The train step over (data, seq) meshes of gloo ranks (tests/torch_ranks.py
``job_seq_model``: each rank holds its rows' bars ``s*R/n .. (s+1)*R/n``,
K1 builds only those, and the bar-axis ops cross ranks through
mst_torch.ops.seq_context) against mst_tpu's dense single-device step on
the same global batch and weights (the mirror of
tests/test_seq_parallel.py:119-151, which compares one leaf; here every
leaf). NARROW widths, a bar bucket of 32, songs of mixed bars and
channels whose last bars lie on different seq ranks. Tolerances:

- fp32 losses rtol 1e-5 and every accumulated gradient leaf rtol 1e-4,
  atol 1e-6 (tests/test_torch_parallel.py's rule: the ranks' partial sums
  are added in another order than the dense sums);
- the bf16 storage and compute step: losses to test_torch_precision.py's
  ``LOSS_TOL`` against mst_tpu under the same policy, gradients within
  5e-2 of each leaf's largest against the port's one-process bf16 step
  (chip_smoke.py's bf16 rule);
- parameters across ranks after an apply, the rasters of a rank's bars,
  the cross-rank flip and final-state read, and a remat step against the
  plain one: exact.

The mutation cases break one guard each and must fail the step check.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.config import Config as JConfig
from mst_tpu.config import ModelConfig as JModelConfig
from mst_tpu.models import StyleTransferModel as JModel
from mst_tpu.runtime import train as jtr
from mst_torch import weights
from mst_torch.config import Config, ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import device_raster as tdr
from mst_torch.ops import seq_context
from mst_torch.ops.rasterize import Rasterizer
from mst_torch.ops.shapes import masked_flip, masked_last
from mst_torch.parallel import Mesh, shard_batch
from mst_torch.runtime import train as ttr
from tests.test_torch_model import NARROW, _params_like
from tests.test_torch_parallel import (GRAD_TOL, LOSS_RTOL, PARAM_TOL, SEEDS,
                                       _bits, _songs, _write_songs)
from tests.test_torch_precision import LOSS_TOL
from tests.torch_ranks import join_ranks, seq_op_inputs, start_ranks

BF16_GRAD_TOL = 5e-2
# the songs of SEEDS capped so that, in a 32-bar bucket, their last bars
# (29, 12, 20, 5) lie on seq ranks 1, 0, 1, 0 of two and 3, 1, 2, 0 of four
CAPS = [30, 13, 21, 6]
CB, RB = 4, 32


def _fake_mesh(n_data, n_seq, data_index=0, seq_index=0):
    """A rank's mesh without a process group (the batch functions run no
    collective)."""
    return Mesh(shape={"data": n_data, "seq": n_seq}, data_index=data_index,
                seq_index=seq_index, data_group=None, seq_group=None,
                device=torch.device("cpu"))


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    paths = _write_songs(str(tmp_path_factory.mktemp("songs")), SEEDS)
    return _songs(paths), paths


def _j_step(j_model, params, j_batch, **policy):
    """mst_tpu's dense first micro-step: (losses, accumulated gradients
    as a state dict)."""
    config = JConfig(model=JModelConfig(**NARROW, **policy))
    opt = jtr.make_optimizer(config)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = jtr.TrainState(
        params=p, opt_state=opt.init(p),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, p),
        micro_step=jnp.zeros((), jnp.int32),
        opt_step=jnp.zeros((), jnp.int32))
    state, vec = jtr.make_train_step(
        j_model, config, j_batch.unpitched is not None,
        fetch_losses=False)(state, j_batch)
    return np.asarray(vec), weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.accum_grads))


def _t_steps(params, t_songs, n, policy="float32"):
    """The port's one-process steps on the global batch: (first losses,
    first accumulated gradients, parameters after ``n`` steps)."""
    config = Config(model=ModelConfig(**NARROW, compute_dtype=policy,
                                      storage_dtype=policy))
    model = StyleTransferModel(config.model)
    model.load_state_dict(weights.state_dict_from_flax(params))
    state = ttr.create_train_state(config, device="cpu", model=model)
    batch = ttr.device_batch_from_songs(t_songs, CB, RB, bar_cap=CAPS,
                                        device="cpu", raster_dtype=policy)
    step = ttr.make_train_step(config, batch.unpitched is not None)
    for i in range(n):
        _, vec = step(state, batch)
        if i == 0:
            first = (vec, {k: q.grad.clone() for k, q in
                           state.model.named_parameters()
                           if q.grad is not None})
    return first + ({k: q.detach().clone() for k, q in
                     state.model.named_parameters()},)


@pytest.fixture(scope="module")
def seq_model(songs, tmp_path_factory):
    """The ranks' results (4 gloo ranks), and meanwhile mst_tpu's dense
    step (fp32 and bf16) and the port's one-process steps on the same
    global batch."""
    pairs, paths = songs
    j_model = JModel(JModelConfig(**NARROW))
    params = _params_like(
        j_model.init, jax.random.PRNGKey(5), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]), jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    tmp = tmp_path_factory.mktemp("seq_model")
    torch.save(weights.state_dict_from_flax(params), tmp / "weights.pt")
    with open(tmp / "inputs.json", "w") as fh:
        json.dump(dict(widths=NARROW, songs=paths, Cb=CB, Rb=RB, caps=CAPS),
                  fh)
    started = start_ranks("seq_model", 4, tmp)

    j_batch = jtr.device_batch_from_songs([j for j, _ in pairs], CB, RB,
                                          bar_cap=CAPS)
    t_songs = [t for _, t in pairs]
    want = dict(
        fp32=_j_step(j_model, params, j_batch),
        bf16=_j_step(JModel(JModelConfig(**NARROW, compute_dtype="bfloat16",
                                         storage_dtype="bfloat16")),
                     params, j_batch, compute_dtype="bfloat16",
                     storage_dtype="bfloat16")[0],
        one=_t_steps(params, t_songs, 2),
        one_bf16=_t_steps(params, t_songs, 1, "bfloat16"))
    return join_ranks(started), want


def _loss_rows(vec):
    vec = np.asarray(vec, np.float64)
    return vec[np.isfinite(vec)]


def _held(ranks, case):
    return [r[case] for r in ranks if case in r]


def _check_step(recs, j_vec, j_grads):
    """Every rank's first micro-step against mst_tpu's dense step."""
    for rec in recs:
        got = rec["losses"].numpy()
        assert np.array_equal(np.isnan(got), np.isnan(j_vec))
        np.testing.assert_allclose(_loss_rows(got), _loss_rows(j_vec),
                                   rtol=LOSS_RTOL)
        assert sorted(rec["grads"]) == sorted(j_grads)
        for name, g in rec["grads"].items():
            np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case,n_ranks", [("1x2", 2), ("1x4", 4),
                                          ("2x2", 4)])
def test_seq_step_matches_dense_step(seq_model, case, n_ranks):
    """Every rank's losses and accumulated gradients after one micro-step
    on its rows' bars equal mst_tpu's dense step on the global batch; the
    ranks hold the same losses and gradients."""
    ranks, want = seq_model
    recs = _held(ranks, case)
    assert len(recs) == n_ranks
    _check_step(recs, *want["fp32"])
    for rec in recs[1:]:
        assert torch.equal(rec["losses"], recs[0]["losses"])
        for name, g in rec["grads"].items():
            assert torch.equal(_bits(g), _bits(recs[0]["grads"][name]))


@pytest.mark.parametrize("case", ["1x2", "1x4", "2x2"])
def test_seq_parameters_bit_equal_across_ranks_after_apply(seq_model, case):
    """The second micro-step applies Adam: every rank holds the same
    bits, which track the port's one-process run."""
    ranks, want = seq_model
    recs = _held(ranks, case)
    for rec in recs:
        assert rec["opt_step"] == 1
        for name, q in rec["params"].items():
            assert torch.equal(_bits(q), _bits(recs[0]["params"][name]))
    for name, q in recs[0]["params"].items():
        np.testing.assert_allclose(q.numpy(), want["one"][2][name].numpy(),
                                   err_msg=name, **PARAM_TOL)


def test_seq_bf16_step_tracks_dense_step(seq_model):
    """Under the bf16 storage and compute policies the (1, 2) step's
    losses track mst_tpu's bf16 step, and its gradients the port's
    one-process bf16 step."""
    ranks, want = seq_model
    _, one_grads, _ = want["one_bf16"]
    for rec in _held(ranks, "1x2-bf16"):
        got = rec["losses"].numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(want["bf16"]))
        np.testing.assert_allclose(_loss_rows(got), _loss_rows(want["bf16"]),
                                   **LOSS_TOL)
        assert sorted(rec["grads"]) == sorted(one_grads)
        for name, g in rec["grads"].items():
            assert g.dtype == torch.float32
            w = one_grads[name]
            err = (g - w).abs().max().item()
            assert err <= BF16_GRAD_TOL * max(w.abs().max().item(), 1e-30), \
                name


@pytest.mark.parametrize("case", ["1x2-local-bar-mask",
                                  "1x2-song-info-every-rank"])
def test_seq_step_check_catches_each_trap(seq_model, case):
    """A bar mask by local index (every rank after the first masks the
    wrong bars) and song-info losses counted on every seq rank (their
    gradient n_seq times): each fails the step check."""
    ranks, want = seq_model
    with pytest.raises(AssertionError):
        _check_step(_held(ranks, case), *want["fp32"])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_remat_over_ranks_equals_plain_step(seq_model, mesh):
    """A remat step (torch.utils.checkpoint) over a data axis and over a
    seq axis gives the plain step's losses and gradients bit for bit,
    with every backward() on a fresh thread: the recompute enters the
    precision policy and the sequence-sharding context itself, and runs
    the same collectives on every rank."""
    ranks, _ = seq_model
    pairs = _held(ranks, f"remat-{mesh}")
    assert len(pairs) == 2
    for plain, remat in pairs:
        assert torch.equal(_bits(remat["losses"]), _bits(plain["losses"]))
        assert sorted(remat["grads"]) == sorted(plain["grads"])
        for name, g in plain["grads"].items():
            assert torch.equal(_bits(remat["grads"][name]), _bits(g)), name


# ------------------------------------------------- the cross-rank ops

@pytest.mark.parametrize("n", [2, 4])
def test_cross_rank_flip_and_last_step_bit_equal_to_dense(seq_model, n):
    """masked_flip_bars and last_step (with lengths that end on several
    ranks, and without) on each rank's chunk: bit-equal to masked_flip,
    masked_last and ``[:, -1]`` of the whole, in value and gradient."""
    ranks, _ = seq_model
    x, lengths, ct_flip, ct_last = seq_op_inputs()
    t_l = x.shape[1] // n
    xd = x.clone().requires_grad_()
    flipped = masked_flip(xd, lengths)
    (flipped * ct_flip).sum().backward()
    dense = {"flip": (flipped.detach(), xd.grad)}
    for key, read in (("last", lambda t: masked_last(t, lengths)),
                      ("last-none", lambda t: t[:, -1])):
        xd = x.clone().requires_grad_()
        last = read(xd)
        (last * ct_last).sum().backward()
        dense[key] = (last.detach(), xd.grad)
    for s, rank in enumerate(r for r in ranks if r["ops"][n] is not None):
        mine = slice(s * t_l, (s + 1) * t_l)
        got = rank["ops"][n]
        for key in ("flip", "last", "last-none"):
            value, grad = dense[key]
            if key == "flip":
                value = value[:, mine]
            assert torch.equal(_bits(got[key][0]), _bits(value)), key
            assert torch.equal(_bits(got[key][1]), _bits(grad[:, mine])), key


def test_last_step_keeps_a_negative_zero(seq_model):
    """The owner's -0.0 reaches every rank through the int32 sum; a float
    all-reduce (the mutation) turns it into +0.0."""
    ranks, _ = seq_model
    for rank in ranks[:2]:
        exact, mutated = rank["ops"][2]["negative-zero"]
        assert torch.equal(exact.view(torch.int32),
                           torch.full_like(exact, -0.0).view(torch.int32))
        assert torch.equal(mutated.view(torch.int32),
                           torch.zeros_like(mutated).view(torch.int32))


def test_sequence_sharding_is_a_noop_without_seq_ranks():
    assert seq_context.current_seq_mesh() is None
    for mesh in (None, _fake_mesh(2, 1)):
        with seq_context.sequence_sharding(mesh):
            assert seq_context.current_seq_mesh() is None
    mesh = _fake_mesh(1, 2)
    with seq_context.sequence_sharding(mesh):
        assert seq_context.current_seq_mesh() is mesh
    assert seq_context.current_seq_mesh() is None
    x = torch.randn(2, 4, 3)
    assert seq_context.seq_sum(x) is x
    assert seq_context.count_once(x)[0] is x
    assert torch.equal(seq_context.last_step(x), x[:, -1])
    with pytest.raises(ValueError, match="seq"):
        with seq_context.sequence_sharding(mesh, axis="data"):
            pass


# --------------------------------------------------- a rank's bars

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_bar_slice_raster_bit_equal_to_dense_slice(songs, dtype, n):
    """Each seq rank's raster (K1's call site with only the notes of its
    bars) is its slice of the whole batch's raster, bit for bit."""
    t_songs = [t for _, t in songs[0]]
    rasterizers = [Rasterizer(s.info) for s in t_songs]
    t_l = RB // n
    for pitched, n_ch in ((True, CB), (False, 1)):
        notes = [(s.pitched_notes if pitched else s.unpitched_notes)[:n_ch]
                 for s in t_songs]
        dense = tdr.device_rasterize_batch(
            rasterizers, notes, pitched, n_ch, RB, CAPS, fuse_nf=True,
            device="cpu", out_dtype=dtype)
        for s in range(n):
            got = tdr.device_rasterize_batch_sharded(
                _fake_mesh(1, n, seq_index=s), rasterizers, notes, pitched,
                n_ch, RB, CAPS, fuse_nf=True, out_dtype=dtype)
            assert got.dtype == dtype and got.shape[2] == t_l
            assert torch.equal(_bits(got),
                               _bits(dense[:, :, s * t_l:(s + 1) * t_l]))


def test_rank_batch_is_its_rows_and_bars(songs):
    """device_batch_from_songs on a (2, 2) mesh: each rank's rows, with
    its bars of the rasters and the per-song fields whole, bit for bit;
    shard_batch of the global batch gives the same."""
    t_songs = [t for _, t in songs[0]]
    dense = ttr.device_batch_from_songs(t_songs, CB, RB, bar_cap=CAPS,
                                        device="cpu")
    for i in range(2):
        for s in range(2):
            mesh = _fake_mesh(2, 2, i, s)
            got = ttr.device_batch_from_songs(t_songs, CB, RB, bar_cap=CAPS,
                                              device="cpu", mesh=mesh)
            want = shard_batch(dense, mesh)
            for name, g, w in zip(ttr.Batch._fields, got, want):
                rows = dense._asdict()[name][2 * i:2 * i + 2]
                if name in ("pitched", "unpitched"):
                    rows = rows[:, :, 16 * s:16 * s + 16]
                assert torch.equal(_bits(g), _bits(w)), name
                assert torch.equal(_bits(g), _bits(rows)), name


def test_indivisible_bar_bucket_raises(songs):
    t_songs = [t for _, t in songs[0]]
    mesh = _fake_mesh(1, 4)
    with pytest.raises(ValueError, match="--seq-parallel 4"):
        ttr.device_batch_from_songs(t_songs, CB, 30, bar_cap=CAPS,
                                    device="cpu", mesh=mesh)
    dense = ttr.device_batch_from_songs(t_songs, CB, 30, bar_cap=CAPS,
                                        device="cpu")
    with pytest.raises(ValueError, match="--seq-parallel 4"):
        shard_batch(dense, mesh)


# ------------------------------------------------------ play_midi

def test_play_midi_writes_mst_tpu_bytes(tmp_path):
    """mst_torch.io.midi.play_midi renders a make_corpus song to the WAV
    bytes mst_tpu's writes."""
    from mst_tpu.io import midi as j_midi
    from mst_tpu.io import smf as j_smf
    from mst_torch.io import midi as t_midi
    from mst_torch.io import smf as t_smf
    path = _write_songs(str(tmp_path), (6,))[0]
    with open(path, "rb") as fh:
        data = fh.read()
    want = j_midi.play_midi(j_smf.parse_midi_bytes(data),
                            str(tmp_path / "jax.wav"))
    got = t_midi.play_midi(t_smf.parse_midi_bytes(data),
                           str(tmp_path / "torch.wav"))
    assert got == str(tmp_path / "torch.wav")
    with open(want, "rb") as a, open(got, "rb") as b:
        want_bytes, got_bytes = a.read(), b.read()
    assert len(got_bytes) > 44 and got_bytes == want_bytes
