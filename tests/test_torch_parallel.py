"""The port's data-parallel layer against mst_tpu's, on the CPU.

``mst_torch.parallel`` (the ranks' join, the corpus partition, the process
mesh), the per-rank K1 call site ``device_rasterize_batch_sharded``, the
data-parallel micro-step and ``train-model-torch.py`` over ranks. Ranks are
processes under gloo (tests/torch_ranks.py: a FileStore in ``tmp_path``, a
timeout on the group and on the join), with narrow widths (the NARROW
config of tests/test_torch_model.py), weights from
``state_dict_from_flax`` and songs from tools/make_corpus.py. Tolerances:

- rasters, per-rank batches and the parameters across ranks: exact;
- losses against mst_tpu's dense step and the port's one-process step:
  rtol 1e-5, and accumulated gradients rtol 1e-4, atol 1e-6 (the rule of
  tests/test_train_parallel.py:150-174): each rank sums its own rows, and
  the ranks' sums are added afterwards, in another order;
- parameters after an apply against the one-process step: rtol 1e-5,
  atol 1e-4 (tests/test_torch_train.py's trajectory rule: Adam's first
  update is about lr * sign(grad));
- the CLI's loss rows over 2 ranks against one process: rtol 1e-5.
"""

import importlib.util
import json
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
from mst_tpu.runtime import train as jtr
from mst_torch import weights
from mst_torch.config import Config, ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import device_raster as tdr
from mst_torch.ops.rasterize import Rasterizer
from mst_torch.parallel import Mesh, mesh as tmesh, multihost, shard_batch
from mst_torch.runtime import train as ttr
from tests.test_torch_model import NARROW, _params_like
from tests.torch_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
# make_corpus seeds of one global batch whose songs differ in bar count
# (39, 99, 48, 43 bars, capped below) and channel count (2, 3, 2, 2), with
# and without percussion, all in 4/4
SEEDS = (0, 5, 245, 250)
CAPS = [16, 9, 12, 6]
CB, RB = 4, 16


def _write_songs(directory, seeds):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_corpus import generate_song
    from mst_tpu.io import create_midi
    from mst_tpu.io import smf as j_smf
    os.makedirs(directory, exist_ok=True)
    paths = []
    for seed in seeds:
        info, instruments = generate_song(np.random.default_rng(seed))
        path = os.path.join(directory, f"s{seed}.mid")
        with open(path, "wb") as fh:
            fh.write(j_smf.encode_midi(create_midi(info, *instruments)))
        paths.append(path)
    return paths


def _songs(paths):
    from mst_tpu.data.pipeline import get_input as j_get_input
    from mst_tpu.io import smf as j_smf
    from mst_tpu.ops.events import read_midi as j_read
    from mst_torch.data.pipeline import get_input as t_get_input
    from mst_torch.io import smf as t_smf
    from mst_torch.ops.events import read_midi as t_read
    out = []
    for path in paths:
        with open(path, "rb") as fh:
            data = fh.read()
        out.append((j_get_input(*j_read(j_smf.parse_midi_bytes(data))),
                    t_get_input(*t_read(t_smf.parse_midi_bytes(data)))))
    return out


def _fake_mesh(n, rank):
    """A mesh as rank ``rank`` of a data axis of ``n`` sees it, without a
    process group (the per-rank batch functions run no collective)."""
    return Mesh(shape={"data": n, "seq": 1}, data_index=rank, seq_index=0,
                data_group=None, seq_group=None,
                device=torch.device("cpu"))


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else
                  torch.int32 if x.dtype == torch.float32 else x.dtype)


# ------------------------------------------------------------- multihost

def test_shard_files_partition_is_exact_and_disjoint():
    files = [f"song{i}.mid" for i in range(13)]
    shards = [multihost.shard_files_for_host(files, process_index=i,
                                             process_count=4)
              for i in range(4)]
    assert sorted(f for s in shards for f in s) == sorted(files)
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    assert shards[2] == multihost.shard_files_for_host(
        files, process_index=2, process_count=4)


def test_shard_files_defaults_to_this_process():
    assert multihost.shard_files_for_host(["a.mid", "b.mid"]) == \
        ["a.mid", "b.mid"]


def test_initialize_multihost_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.initialize_multihost() is False
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize_multihost(num_processes=2, process_id=0)


def test_initialize_multihost_forwards_args(monkeypatch):
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 1)
    # a single-rank group: formed, but not a run over ranks
    assert multihost.initialize_multihost("10.0.0.1:1234", 2, 1,
                                          backend="gloo", timeout=7) is False
    assert calls[-1]["init_method"] == "tcp://10.0.0.1:1234"
    assert (calls[-1]["world_size"], calls[-1]["rank"],
            calls[-1]["backend"]) == (2, 1, "gloo")
    assert calls[-1]["timeout"].total_seconds() == 7
    # the launcher's variables; the backend derived from the device: nccl
    # for one rank per card, gloo on the CPU
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    multihost.initialize_multihost()
    assert calls[-1] == dict(backend="nccl", init_method="env://",
                             world_size=4, rank=3)
    multihost.initialize_multihost(device="cpu")
    assert calls[-1]["backend"] == "gloo"


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", "2", 0, "gloo"),
    ("cuda", None, 1, "nccl"),
    ("cuda", "2", 2, "nccl"),
    ("cuda", "2", 1, "gloo"),       # two ranks share the one card
    ("cuda:1", "8", 4, "gloo"),
])
def test_default_backend(monkeypatch, device, local, cards, want):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.default_backend(device) == want


@pytest.mark.parametrize("device", [None, "cuda", "cuda:1"])
def test_default_backend_raises_without_a_card(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.default_backend(device)


@pytest.mark.parametrize("local,cards,want", [("1", 2, 1), ("3", 2, 1),
                                              (None, 2, 0)])
def test_local_device_makes_the_rank_card_current(monkeypatch, local, cards,
                                                  want):
    """Card ``LOCAL_RANK`` modulo the cards becomes the thread's current
    device: the kernels' C launchers and the rank's streams live there."""
    if local is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local)
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    assert tmesh.local_device() == torch.device("cuda", want)
    assert current == [torch.device("cuda", want)]
    # an explicit card is made current too; the CPU sets nothing
    assert tmesh.local_device("cuda:0") == torch.device("cuda", 0)
    assert current[-1] == torch.device("cuda", 0)
    assert tmesh.local_device("cpu") == torch.device("cpu")
    assert len(current) == 2


def test_two_processes_all_reduce_and_shard_the_corpus(tmp_path):
    ranks = run_ranks("allreduce", 2, tmp_path)
    for rec in ranks:
        assert rec["sum"] == [1.0, 201.0]
    assert not set(ranks[0]["shard"]) & set(ranks[1]["shard"])
    assert sorted(ranks[0]["shard"] + ranks[1]["shard"]) == \
        sorted(f"song{i}.mid" for i in range(7))


# --------------------------------------------------- per-rank rasters

@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """[(mst_tpu Song, mst_torch Song)] of SEEDS, and their MIDI files."""
    paths = _write_songs(str(tmp_path_factory.mktemp("songs")), SEEDS)
    return _songs(paths), paths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_raster_bit_equal_to_dense_slice(songs, dtype, n):
    """Each rank's raster (its songs alone through K1's call site) is its
    slice of the whole batch's raster, bit for bit (mirrors
    tests/test_train_parallel.py:327 on synthetic songs)."""
    t_songs = [t for _, t in songs[0]]
    rasterizers = [Rasterizer(s.info) for s in t_songs]
    for pitched, n_ch in ((True, CB), (False, 1)):
        notes = [(s.pitched_notes if pitched else s.unpitched_notes)[:n_ch]
                 for s in t_songs]
        dense = tdr.device_rasterize_batch(
            rasterizers, notes, pitched, n_ch, RB, CAPS, fuse_nf=True,
            device="cpu", out_dtype=dtype)
        rows = len(t_songs) // n
        for rank in range(n):
            got = tdr.device_rasterize_batch_sharded(
                _fake_mesh(n, rank), rasterizers, notes, pitched, n_ch, RB,
                CAPS, fuse_nf=True, out_dtype=dtype)
            assert got.dtype == dtype
            assert torch.equal(_bits(got),
                               _bits(dense[rank * rows:(rank + 1) * rows]))


def test_sharded_raster_needs_a_divisible_batch(songs):
    t_songs = [t for _, t in songs[0]][:3]
    with pytest.raises(ValueError, match="not divisible"):
        tdr.device_rasterize_batch_sharded(
            _fake_mesh(2, 0), [Rasterizer(s.info) for s in t_songs],
            [s.pitched_notes for s in t_songs], True, CB, RB, CAPS[:3])
    with pytest.raises(ValueError, match="not divisible"):
        ttr.device_batch_from_songs(t_songs, CB, RB, bar_cap=CAPS[:3],
                                    device="cpu", mesh=_fake_mesh(2, 1))


@pytest.mark.parametrize("n", [2, 4])
def test_rank_batch_is_its_rows_of_the_global_batch(songs, n):
    """device_batch_from_songs(mesh=...) gives each rank its rows of the
    global batch, field for field and bit for bit, with the global
    batch's Cb and Rb, and the unpitched raster and mask on every rank
    when any song has percussion; shard_batch of the global batch gives
    the same rows."""
    t_songs = [t for _, t in songs[0]]
    dense = ttr.device_batch_from_songs(t_songs, CB, RB, bar_cap=CAPS,
                                        device="cpu")
    rows = len(t_songs) // n
    for rank in range(n):
        mesh = _fake_mesh(n, rank)
        got = ttr.device_batch_from_songs(t_songs, CB, RB, bar_cap=CAPS,
                                          device="cpu", mesh=mesh)
        for want_batch in (dense, shard_batch(dense, mesh)):
            for name, g, w in zip(ttr.Batch._fields, got, want_batch):
                assert (g is None) == (w is None), name
                if g is not None:
                    want = w if want_batch is not dense else \
                        w[rank * rows:(rank + 1) * rows]
                    assert torch.equal(_bits(g), _bits(want)), name
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(dense, _fake_mesh(3, 0))


# ------------------------------------------------ the data-parallel step

@pytest.fixture(scope="module")
def data_parallel(songs, tmp_path_factory):
    """The ranks' results (4 gloo ranks: data axes of 4 and of 2), and the
    same steps on the global batch by mst_tpu and by the port in one
    process."""
    pairs, paths = songs
    j_model = JModel(JModelConfig(**NARROW))
    params = _params_like(
        j_model.init, jax.random.PRNGKey(3), jnp.array([[1.0, 0.0]]),
        jnp.array([120.0]), jnp.zeros((1, 1, 2, 4, 10, 56, 5)),
        jnp.zeros((1, 1, 51)).at[0, 0, 0].set(1.0),
        jnp.zeros((1, 1, 2, 4, 10, 47, 2)))
    t_config = Config(model=ModelConfig(**NARROW))
    tmp = tmp_path_factory.mktemp("data_parallel")
    torch.save(weights.state_dict_from_flax(params), tmp / "weights.pt")
    with open(tmp / "inputs.json", "w") as fh:
        json.dump(dict(widths=NARROW, songs=paths, Cb=CB, Rb=RB, caps=CAPS),
                  fh)
    ranks = run_ranks("data_parallel", 4, tmp)

    # mst_tpu's dense step on the global batch
    j_config = JConfig(model=JModelConfig(**NARROW))
    j_batch = jtr.device_batch_from_songs([j for j, _ in pairs], CB, RB,
                                          bar_cap=CAPS)
    has_u = j_batch.unpitched is not None
    opt = jtr.make_optimizer(j_config)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = jtr.TrainState(
        params=p, opt_state=opt.init(p),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, p),
        micro_step=jnp.zeros((), jnp.int32),
        opt_step=jnp.zeros((), jnp.int32))
    state, j_vec = jtr.make_train_step(j_model, j_config, has_u,
                                       fetch_losses=False)(state, j_batch)
    j_grads = weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.accum_grads))

    # the port's one-process step on the same batch
    model = StyleTransferModel(t_config.model)
    model.load_state_dict(weights.state_dict_from_flax(params))
    t_state = ttr.create_train_state(t_config, device="cpu", model=model)
    t_batch = ttr.device_batch_from_songs([t for _, t in pairs], CB, RB,
                                          bar_cap=CAPS, device="cpu")
    step = ttr.make_train_step(t_config, has_u)
    _, vec1 = step(t_state, t_batch)
    t_grads = {n: q.grad.clone() for n, q in
               t_state.model.named_parameters() if q.grad is not None}
    _, vec2 = step(t_state, t_batch)
    one = dict(losses=[vec1, vec2], grads=t_grads,
               params={n: q.detach().clone() for n, q in
                       t_state.model.named_parameters()})
    return ranks, np.asarray(j_vec), j_grads, one


def _loss_rows(vec):
    """The finite losses (the unpitched ones are NaN without percussion)."""
    vec = np.asarray(vec, np.float64)
    return vec[np.isfinite(vec)]


@pytest.mark.parametrize("n", [4, 2])
def test_data_parallel_step_matches_dense_step(data_parallel, n):
    """Rank 0's losses and accumulated gradients after one micro-step on
    its rows equal mst_tpu's dense step and the port's one-process step
    on the global batch; every rank sees the same losses."""
    ranks, j_vec, j_grads, one = data_parallel
    rec = ranks[0][n]
    got = rec["losses"][0].numpy()
    assert np.array_equal(np.isnan(got), np.isnan(j_vec))
    np.testing.assert_allclose(_loss_rows(got), _loss_rows(j_vec),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(_loss_rows(got),
                               _loss_rows(one["losses"][0]), rtol=LOSS_RTOL)
    for r in ranks[1:]:
        assert torch.equal(r[n]["losses"][0], rec["losses"][0])
    assert sorted(rec["grads"]) == sorted(one["grads"])
    for name, g in rec["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), one["grads"][name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("n", [4, 2])
def test_mean_of_rank_losses_is_not_the_global_loss(data_parallel, n):
    """The songs differ in bars and channels, so the mean of the losses
    each rank would compute from its rows alone is another objective: it
    lies outside ten times the tolerance that the data-parallel loss
    meets (or is NaN: a rank whose rows have no percussion divides its
    unpitched sums 0/0)."""
    ranks, j_vec, _, _ = data_parallel
    naive = np.mean([r[n]["alone"] for r in ranks
                     if r[n]["seq_index"] == 0])
    global_loss = float(j_vec[0])
    assert not np.isclose(naive, global_loss, rtol=10 * LOSS_RTOL, atol=0)
    got = float(ranks[0][n]["losses"][0][0])
    assert np.isclose(got, global_loss, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("n", [4, 2])
def test_parameters_bit_equal_across_ranks_after_apply(data_parallel, n):
    """The second micro-step applies Adam (iter_size 2): every rank holds
    the same bits, which track the one-process run; rank 1 started from
    other parameters, which ``replicate`` overwrote."""
    ranks, _, _, one = data_parallel
    first = ranks[0][n]
    assert first["opt_step"] == 1
    for r in ranks[1:]:
        assert r[n]["opt_step"] == 1
        for name, q in r[n]["params"].items():
            assert torch.equal(_bits(q), _bits(first["params"][name])), name
    np.testing.assert_allclose(first["losses"][1].numpy(),
                               one["losses"][1].numpy(), rtol=LOSS_RTOL)
    for name, q in first["params"].items():
        np.testing.assert_allclose(q.numpy(), one["params"][name].numpy(),
                                   err_msg=name, **PARAM_TOL)


def test_stacked_steps_over_ranks_equal_single_steps(data_parallel):
    """make_multi_train_step with a mesh reads a b-major stack (a rank's
    rows are whole b blocks): two stacked steps give two single steps'
    losses, bit for bit."""
    ranks, _, _, _ = data_parallel
    for r in ranks:
        rec = r[2]
        assert torch.equal(rec["stacked"], torch.stack(rec["single"]))


# ---------------------------------------------------------------- the CLI

def _cli():
    spec = importlib.util.spec_from_file_location(
        "train_model_torch", os.path.join(ROOT, "train-model-torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cli_rows_match(tmp_path, name_one, name_two, rows):
    """Two loss logs with the same rows (a row may carry more columns than
    the header, once the unpitched losses appear), each finite loss
    within ``LOSS_RTOL``, and the same snapshots."""
    import csv
    logs = []
    for name in (name_one, name_two):
        with open(tmp_path / f"{name}.csv") as fh:
            logs.append(list(csv.reader(fh)))
    one, two = logs
    assert len(one) == len(two) == rows + 1 and one[0] == two[0]
    for a, b in zip(one[1:], two[1:]):
        assert len(a) == len(b) and a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if x not in ("", "nan"):
                np.testing.assert_allclose(float(y), float(x),
                                           rtol=LOSS_RTOL)
    assert sorted(os.listdir(tmp_path / name_two)) == \
        sorted(os.listdir(tmp_path / name_one))


def _cli_argv(tmp_path, name, iters, *extra):
    return ["--data", str(tmp_path / "data"), "--device", "cpu",
            "--iters", str(iters), "--seed", "3",
            "--csv", str(tmp_path / f"{name}.csv"),
            "--snapshots", str(tmp_path / name), *extra]


def _cli_over_two_ranks(tmp_path, argv):
    ranks_dir = tmp_path / "ranks"
    ranks_dir.mkdir()
    with open(ranks_dir / "inputs.json", "w") as fh:
        json.dump(dict(argv=argv), fh)
    return run_ranks("cli", 2, ranks_dir)


def test_cli_over_two_ranks_matches_one_process(tmp_path):
    """``train-model-torch.py --device cpu --batch-size 2
    --iters 2`` on 2 ranks: one CSV of 2 rows (rank 0 alone writes it),
    whose losses are the one-process ``--batch-size 2`` run's, and the
    same snapshots."""
    data = _write_songs(str(tmp_path / "data"), (0, 245, 250))
    _cli().main(_cli_argv(tmp_path, "one", 2, "--batch-size", "2"))
    ranks = _cli_over_two_ranks(tmp_path, _cli_argv(
        tmp_path, "two", 2, "--batch-size", "2"))
    assert [(r["micro_step"], r["opt_step"]) for r in ranks] == [(2, 1)] * 2
    assert len(data) == 3
    _cli_rows_match(tmp_path, "one", "two", rows=2)


def test_cli_stops_every_rank_on_a_nonfinite_loss(tmp_path):
    """A NaN in the global losses (planted after each rank's real step)
    stops both ranks at the finiteness check of the first step, well
    inside the group timeout: no rank goes on into the next step's
    collectives while another has stopped."""
    _write_songs(str(tmp_path / "data"), (0, 245))
    with open(tmp_path / "inputs.json", "w") as fh:
        json.dump(dict(nan=True, argv=[
            "--data", str(tmp_path / "data"), "--device", "cpu",
            "--iters", "4", "--batch-size", "2", "--seed", "3",
            "--csv", str(tmp_path / "nan.csv"),
            "--snapshots", str(tmp_path / "nan")]), fh)
    ranks = run_ranks("cli", 2, tmp_path, timeout=100)
    for rec in ranks:
        assert rec["raised"].startswith("AssertionError"), rec
        assert "nan" in rec["raised"]
    assert os.listdir(tmp_path / "nan") == []      # nothing was saved


def test_rank_parity_script_on_two_cpu_ranks(tmp_path, capsys):
    """rank-parity-torch.py, the check that the card runs use: the CLI
    over 2 ranks (torch.distributed.run on localhost, a free port) against
    one process, within its rtol."""
    spec = importlib.util.spec_from_file_location(
        "rank_parity_torch", os.path.join(ROOT, "rank-parity-torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--ranks", "2", "--batch-size", "2", "--iters", "1",
                        "--device", "cpu", "--out", str(tmp_path),
                        "--timeout", "240"]) == 0
    assert "rows 1/1" in capsys.readouterr().out


def test_cli_seq_parallel_over_two_ranks_matches_one_process(tmp_path):
    """``train-model-torch.py --device cpu --seq-parallel 2 --iters 4`` on
    2 ranks, each holding half of every song's bars (the bar-sharded
    model at full width): the one-process run's loss rows and snapshots."""
    _write_songs(str(tmp_path / "data"), (0, 250))
    _cli().main(_cli_argv(tmp_path, "one", 4))
    ranks = _cli_over_two_ranks(tmp_path, _cli_argv(
        tmp_path, "seq", 4, "--seq-parallel", "2"))
    assert [(r["micro_step"], r["opt_step"]) for r in ranks] == [(4, 2)] * 2
    _cli_rows_match(tmp_path, "one", "seq", rows=4)
