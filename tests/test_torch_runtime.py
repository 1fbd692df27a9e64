"""The port's training runtime helpers against mst_tpu's, on the CPU: the
song cache and the prefetch thread (copies), the metrics (ProgressBar
without tqdm, CsvLogger, flatten_losses, StepTimer), the learning-rate
schedule, and the remat path of the train step. Everything here is exact,
apart from remat, which recomputes the same forward: its losses and
gradients must be bit-equal too; and the schedule, which JAX evaluates in
float32: three roundings (lr, gamma^k, their product), so rtol 3 * 2^-23
against the port's float64.
"""

import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

from mst_torch.data.cache import SongCache
from mst_torch.data.pipeline import iter_inputs
from mst_torch.data.prefetch import prefetch_iterator
from mst_torch.runtime import metrics

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four synthetic songs and one file that is not MIDI."""
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_tpu.io import create_midi, native

    root = tmp_path_factory.mktemp("corpus")
    paths = []
    for seed in (0, 245, 250, 235):
        info, instruments = generate_song(np.random.default_rng(seed))
        path = str(root / f"s{seed}.mid")
        native.write_midi_file(path, create_midi(info, *instruments))
        paths.append(path)
    bad = root / "bad.mid"
    bad.write_bytes(b"not midi")
    return paths + [str(bad)]


def _take(files, n, cache=None, start_at=0):
    it = iter_inputs(files, shuffle=True, looped=True,
                     rng=np.random.default_rng(7), start_at=start_at,
                     cache=cache, min_n_messages=10)
    return [next(it) for _ in range(n)]


def test_cached_stream_matches_uncached_and_mst_tpu(corpus):
    """Two epochs through the port's SongCache give the uncached stream
    (order, cursors, songs), which is mst_tpu's stream; the bad file is
    cached as bad; a resume from a cursor replays the continuation."""
    from mst_tpu.data.cache import SongCache as JCache
    from mst_tpu.data.pipeline import iter_inputs as j_iter_inputs

    n = 8
    cache = SongCache()
    plain = _take(corpus, n)
    cached = _take(corpus, n, cache=cache)
    j_it = j_iter_inputs(corpus, shuffle=True, looped=True,
                         rng=np.random.default_rng(7), cache=JCache(),
                         min_n_messages=10)
    j_stream = [next(j_it) for _ in range(n)]
    for (fa, a), (fb, b), (fj, j) in zip(plain, cached, j_stream):
        assert fa == fb == fj
        assert a.cursor == b.cursor == j.cursor
        assert a.pitched_shape == b.pitched_shape == j.pitched_shape
        assert a.has_unpitched == b.has_unpitched == j.has_unpitched
        np.testing.assert_array_equal(a.pitched, b.pitched)
        np.testing.assert_array_equal(a.pitched, j.pitched)
    assert cache.hits > 0
    assert cache.get(corpus[-1]) is SongCache.BAD
    resumed = _take(corpus, 3, cache=cache, start_at=plain[2][1].cursor)
    assert [f for f, _ in resumed] == [f for f, _ in plain[3:6]]


def test_cache_budget_evicts_lru_first(corpus):
    songs = [s for _, s in _take(corpus, 4)]
    cache = SongCache(max_bytes=songs[0].nbytes + songs[1].nbytes)
    cache.put(songs[0].path, songs[0].slim())
    cache.put(songs[1].path, songs[1].slim())
    assert cache.get(songs[0].path) is not None      # 0 is now the newest
    cache.put(songs[2].path, songs[2].slim())
    assert cache.get(songs[1].path) is None          # 1 was evicted
    assert cache.nbytes <= cache.max_bytes
    assert cache.stats()["songs"] == len(cache)


def test_prefetch_iterator_order_and_exceptions():
    assert list(prefetch_iterator(iter(range(20)), depth=3)) == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("upstream failed")

    it = prefetch_iterator(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="upstream failed"):
        next(it)


def test_progress_bar_matches_mst_tpu():
    """The EMA averages of the tqdm-free bar equal mst_tpu's, a NaN skips
    its metric as there, and the bar closes itself at n_iterations."""
    from mst_tpu.runtime import metrics as jm

    rows = [dict(loss=v, other=2 * v)
            for v in (1.0, 0.5, 0.0, float("nan"), 0.25, 2.0)]
    out = io.StringIO()
    bar = metrics.ProgressBar(len(rows), stream=out)
    j_bar = jm.ProgressBar(len(rows))
    for row in rows:
        bar.add(1, **row)
        j_bar.add(1, **row)
    assert bar.avg_values == pytest.approx(j_bar.avg_values, rel=1e-12)
    assert bar.closed and out.getvalue().endswith("\n")
    assert f"{len(rows)}/{len(rows)}" in out.getvalue()


@pytest.mark.parametrize("n_steps", [1, 2, 3, 6])
def test_step_timer_discards_warmup_like_mst_tpu(monkeypatch, n_steps):
    """With a stubbed clock (step i takes i + 1 s): the times, and the mean
    of the steps after the warm-up (of all of them when there are no
    more), equal mst_tpu's StepTimer's."""
    from mst_tpu.runtime import metrics as jm

    def run(timer_cls, **kwargs):
        ticks = iter(np.cumsum([0] + [v for i in range(n_steps)
                                      for v in (i + 1, 0.5)]).tolist())
        monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(ticks))
        timer = timer_cls(**kwargs)
        for _ in range(n_steps):
            with timer:
                pass
        monkeypatch.undo()
        return timer

    got, want = run(metrics.StepTimer, device="cpu"), run(jm.StepTimer)
    assert got.times == want.times == [float(i + 1) for i in range(n_steps)]
    assert got.mean == want.mean
    assert got.mean == (np.mean(got.times[2:]) if n_steps > 2
                        else np.mean(got.times))


def test_step_timer_waits_for_the_card_and_never_falls_back(monkeypatch):
    """On a CUDA device the timer synchronises before it reads the clock
    (at entry and exit); without a card, asking for one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.StepTimer(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    timer = metrics.StepTimer(warmup=0, device="cuda:0")
    with timer:
        assert len(synced) == 1
    assert synced == [torch.device("cuda:0")] * 2 and len(timer.times) == 1
    with metrics.StepTimer(device=None):
        pass
    assert len(synced) == 2


def test_lr_schedule_matches_mst_tpu_and_steplr():
    """make_lr_schedule against mst_tpu's schedule (jnp, float32), and the
    rates of make_optimizer's scheduler against it and against the
    original's StepLR(200, 0.9), each stepped once per apply, at every
    optimizer step 0..1000 (decays at 200, 400, ...)."""
    import jax.numpy as jnp

    from mst_tpu.config import Config as JConfig
    from mst_tpu.runtime import train as jtr
    from mst_torch.config import Config
    from mst_torch.runtime import make_lr_schedule
    from mst_torch.runtime import train as tr

    steps = np.arange(1001)
    want = np.asarray(jtr.make_lr_schedule(JConfig())(jnp.asarray(steps)))
    schedule = make_lr_schedule(Config())
    got = np.array([schedule(int(i)) for i in steps])
    np.testing.assert_allclose(got, want, rtol=3 * 2.0 ** -23)
    assert got[199] == 0.01 and got[200] == pytest.approx(0.009, rel=1e-15)

    def rates(optimizer, scheduler):
        out = []
        for _ in steps:
            out.append(optimizer.param_groups[0]["lr"])
            optimizer.step()
            scheduler.step()
        return out

    optimizer, scheduler = tr.make_optimizer(torch.nn.Linear(2, 2),
                                             Config())
    np.testing.assert_allclose(rates(optimizer, scheduler), got,
                               rtol=1e-15)
    original = torch.optim.Adam(torch.nn.Linear(2, 2).parameters(),
                                lr=0.01)
    step_lr = torch.optim.lr_scheduler.StepLR(original, step_size=200,
                                              gamma=0.9)
    np.testing.assert_allclose(rates(original, step_lr), got, rtol=1e-15)


def test_csv_logger_and_flatten_losses(tmp_path):
    """Header on create, reserved column names land in the CSV, and the
    flattened names of a LossDict are mst_tpu's."""
    from mst_tpu.ops.losses import LossDict as JLossDict
    from mst_tpu.runtime import metrics as jm
    from mst_torch.ops.losses import LossDict

    path = str(tmp_path / "log.csv")
    logger = metrics.CsvLogger(path)
    logger.append(path="song.mid", data=0.5, fieldnames=2, when_exists=3)
    logger.append(path="b.mid", data=1, fieldnames=3, when_exists=4)
    lines = open(path).read().strip().splitlines()
    assert lines == ["path,data,fieldnames,when_exists", "song.mid,0.5,2,3",
                     "b.mid,1,3,4"]
    for unpitched in (0.5, float("nan")):
        values = [0.1 * (i + 1) for i in range(15)]
        values[7] = unpitched
        got = metrics.flatten_losses(LossDict(*(torch.tensor(v)
                                               for v in values)))
        want = jm.flatten_losses(JLossDict(*values))
        assert list(got) == list(want)
        assert all((got[k] is None and want[k] is None)
                   or got[k] == pytest.approx(want[k]) for k in want)


def test_profiler_trace(tmp_path):
    from mst_torch.runtime.profile import load_events

    with metrics.profiler_trace(str(tmp_path / "prof")) as step:
        torch.ones(4).mean()        # the warm-up step
        step()
        torch.ones(4).sum()
    names = {e["name"] for e in load_events(str(tmp_path / "prof"))}
    assert "aten::sum" in names


def _backward_on_fresh_thread(backward):
    """``Tensor.backward`` run on a new thread, which starts without the
    caller's context variables, as the CUDA autograd engine's device thread
    does."""
    def run(self, *args, **kwargs):
        failed = []

        def target():
            try:
                backward(self, *args, **kwargs)
            except BaseException as e:      # re-raised on the caller
                failed.append(e)

        thread = threading.Thread(target=target)
        thread.start()
        thread.join()
        if failed:
            raise failed[0]
    return run


@pytest.mark.parametrize("compute,storage", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_remat_step_equals_plain_step(corpus, monkeypatch, compute, storage):
    """The train step with remat (torch.utils.checkpoint) gives the plain
    step's losses and gradients, bit for bit, under each numeric policy,
    with every backward() on a fresh thread (the recompute must enter the
    policy itself)."""
    from mst_torch.config import Config, ModelConfig, TrainConfig
    from mst_torch.runtime import train as tr
    from tests.test_torch_model import NARROW

    monkeypatch.setattr(torch.Tensor, "backward",
                        _backward_on_fresh_thread(torch.Tensor.backward))
    song = _take(corpus[:1], 1)[0][1]
    batch = tr.device_batch_from_songs([song], 2, 8, bar_cap=6, device="cpu",
                                       raster_dtype=storage)
    has_u = batch.unpitched is not None
    out = []
    for remat in (False, True):
        config = Config(model=ModelConfig(**NARROW, compute_dtype=compute,
                                          storage_dtype=storage),
                        train=TrainConfig(remat=remat))
        state = tr.create_train_state(config, device="cpu", seed=2)
        _, vec = tr.make_train_step(config, has_u)(
            state, batch)
        out.append((vec, {n: p.grad.clone() for n, p in
                          state.model.named_parameters()
                          if p.grad is not None}))
    (vec_a, grads_a), (vec_b, grads_b) = out
    assert torch.equal(vec_a, vec_b)
    assert grads_a.keys() == grads_b.keys()
    for name in grads_a:
        assert torch.equal(grads_a[name], grads_b[name]), name
