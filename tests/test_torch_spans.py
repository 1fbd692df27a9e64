"""The port's spans and counters (mst_torch.runtime.profile) on the CPU.

- spans nest, each with its self time, in units with ids of their own;
  counters count against the open unit; a ``spanned`` function is a unit
  each call; each thread keeps its own stack, and threads recording at
  once lose no unit; the ring keeps the last units; the recorder switches
  off;
- a span is a ``user_annotation`` range of a ``torch.profiler`` trace
  only while a profiler records, and its unit says so, on any thread;
- a CPU ``transfer_styles`` records one ``transfer.request`` unit with
  its stages, one ``transfer.repack`` for the records packed again at the
  exact pool tier, and no ``transfer.redispatch``; a ``StageTimer``
  timing a request reads the unit's stages and self times, and waits for
  the card as each stage closes but ``UNSYNCED_STAGES``;
- the benchmark's span readers read the window's units and leave out
  the ones a profiler saw.
"""

import os
import sys
import threading
import time

import pytest
import torch

from mst_torch.runtime import profile as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last(root):
    return tp.units(root)[-1]


def test_spans_nest_by_self_time_in_units():
    with tp.span("t.root"):
        tp.count("t.events")
        with tp.span("t.a"):
            with tp.span("t.b"):
                time.sleep(0.002)
            tp.count("t.events", 2)
        with tp.span("t.a"):
            time.sleep(0.001)
    first = _last("t.root")
    with tp.span("t.root"):
        pass
    second = _last("t.root")
    assert second.id > first.id
    assert set(first.spans) == {"t.root", "t.a", "t.b"}
    assert first.spans["t.b"] >= 0.002
    assert first.spans["t.a"] >= 0.001          # both spans of the name
    assert sum(first.spans.values()) == pytest.approx(first.seconds,
                                                      abs=1e-9)
    assert first.counters == {"t.events": 3}
    assert not first.profiled
    tp.count("t.events")                        # no unit open: not counted
    assert second.counters == {}


def test_a_spanned_function_is_a_unit_each_call():
    @tp.spanned("t.spanned")
    def work(x, y=1):
        """The work."""
        with tp.span("t.spanned.inner"):
            tp.count("t.calls")
        return x + y

    before = len(tp.units("t.spanned"))
    assert work(2, y=3) == 5 and work(1) == 2
    kept = tp.units("t.spanned")[before:]
    assert len(kept) == 2 and kept[0].id != kept[1].id
    assert all(set(u.spans) == {"t.spanned", "t.spanned.inner"}
               and u.counters == {"t.calls": 1} for u in kept)
    assert work.__name__ == "work" and work.__doc__ == "The work."


def test_each_thread_keeps_its_own_stack():
    inside = threading.Event()
    done = threading.Event()

    def worker():
        inside.wait()
        with tp.span("t.worker"):
            tp.count("t.worker_events")
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with tp.span("t.main"):
        inside.set()
        done.wait()
    thread.join()
    work, main = _last("t.worker"), _last("t.main")
    assert set(work.spans) == {"t.worker"}
    assert work.counters == {"t.worker_events": 1}
    assert set(main.spans) == {"t.main"} and main.counters == {}
    assert work.id != main.id


def test_threads_lose_no_unit():
    """Many threads record units of one root at once, switching often:
    every unit lands in the ring once, with an id of its own."""
    before = len(tp.units("t.shared"))
    n_threads, n_units = 16, 200

    def worker():
        for _ in range(n_units):
            with tp.span("t.shared"):
                with tp.span("t.shared.inner"):
                    tp.count("t.n")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    kept = tp.units("t.shared")[before:]
    assert len(kept) == n_threads * n_units
    assert len({u.id for u in kept}) == len(kept)
    assert all(u.counters == {"t.n": 1} and set(u.spans) ==
               {"t.shared", "t.shared.inner"} for u in kept)


def test_the_ring_keeps_the_last_units(monkeypatch):
    assert tp.RING_UNITS >= 8192
    monkeypatch.setattr(tp, "RING_UNITS", 3)
    for _ in range(5):
        with tp.span("t.ring"):
            pass
    kept = tp.units("t.ring")
    assert len(kept) == 3
    assert [u.id for u in kept] == sorted(u.id for u in kept)


def test_the_recorder_switches_off(monkeypatch):
    before = len(tp.units("t.off"))
    monkeypatch.setattr(tp, "ENABLED", False)
    with tp.span("t.off"):
        tp.count("t.events")
    assert len(tp.units("t.off")) == before


def test_spans_are_ranges_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    with tp.span("t.unprofiled"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tp.span("t.profiled"):
            with tp.span("t.profiled.inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"t.profiled", "t.profiled.inner"} <= names
    assert "t.unprofiled" not in names
    assert _last("t.profiled").profiled
    assert not _last("t.unprofiled").profiled
    assert not tp.profiler_active()


def test_a_worker_threads_unit_under_a_profiler_is_flagged():
    """A profiler started on the main thread flags the units that another
    thread opens while it records (the prefetch thread's batch builds
    during a traced block), and none after it stops."""
    from torch.profiler import ProfilerActivity, profile

    def unit(root):
        def worker():
            with tp.span(root):
                pass

        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
        return _last(root)

    with profile(activities=[ProfilerActivity.CPU]):
        during = unit("t.worker.during")
    after = unit("t.worker.after")
    assert during.profiled
    assert not after.profiled


def _request_songs(tmp_path):
    """One composition and one style of 12 bars (a 16-bar bucket once
    ``BAR_BUCKETS`` is patched), written to ``tmp_path``."""
    from benchmark.gen import songs

    size = dict(numer=4, n_bars=12, n_pitched=2, drums=True)
    blobs, _ = songs.make_pool(5, 2, sizes=[size, size])
    paths = [str(tmp_path / f"{name}.mid") for name in ("c", "s")]
    for path, blob in zip(paths, blobs):
        with open(path, "wb") as fh:
            fh.write(blob)
    return paths


@pytest.mark.parametrize("fuse", [True, False],
                         ids=["one-program", "two-program"])
def test_a_timed_request_reads_its_units_stages(tmp_path, monkeypatch,
                                                 fuse):
    """A ``StageTimer`` on a card (its synchronize stubbed) timing a CPU
    request holds the stage names of the request's unit, each with the
    unit's self time; every stage but ``UNSYNCED_STAGES`` waits for the
    card as it closes, and a request that nothing times waits for
    nothing."""
    import mst_torch.transfer as tt

    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(
                            tp._local.stack[-1].name))
    monkeypatch.setattr(tt, "BAR_BUCKETS", (16,) + tt.BAR_BUCKETS)
    comp, style = _request_songs(tmp_path)
    bundle = tt.ModelBundle.from_npz(device="cpu", fuse_requests=fuse)
    timer = tp.StageTimer("cuda")
    tt.transfer_styles(bundle, [comp], [style], str(tmp_path / "timed"),
                       stage=timer)
    unit = _last(tt.REQUEST_SPAN)
    stages = {k: v for k, v in unit.spans.items() if k != tt.REQUEST_SPAN}
    assert timer.times == stages
    assert {tt.STAGE_EXTRACT_BLOCK, tt.STAGE_ORIGINALS,
            tt.STAGE_SHARD_APPLY.format(0)} <= set(stages)
    unsynced = {name.format(0) for name in tt.UNSYNCED_STAGES}
    assert set(synced) == set(stages) - unsynced
    assert len(unsynced & set(stages)) == (5 if fuse else 6)
    synced.clear()
    tt.transfer_styles(bundle, [comp], [style], str(tmp_path / "plain"))
    assert synced == []
    assert set(_last(tt.REQUEST_SPAN).spans) == set(unit.spans) - {
        tt.STAGE_EXTRACT_BLOCK}


def test_a_cpu_request_is_one_unit(tmp_path, monkeypatch):
    """One composition and one style of 12 bars (a 16-bar bucket) through
    the one-program request, with the record pool's first tier too
    small, so the ladder packs the records again: one unit with the
    request's stages, its program run, the re-pack and no re-dispatch."""
    import mst_torch.transfer as tt

    comp, style = _request_songs(tmp_path)
    bundle = tt.ModelBundle.from_npz(device="cpu")
    bundle.pool_hint_p = bundle.pool_hint_u = 1
    monkeypatch.setattr(tt, "POOL_TIERS", (16,) + tt.POOL_TIERS)
    monkeypatch.setattr(tt, "BAR_BUCKETS", (16,) + tt.BAR_BUCKETS)
    before = len(tp.units(tt.REQUEST_SPAN))
    tt.transfer_styles(bundle, [comp], [style], str(tmp_path / "out"))
    assert len(tp.units(tt.REQUEST_SPAN)) == before + 1
    unit = _last(tt.REQUEST_SPAN)
    runs = bundle.programs.runs
    assert [k.split(":")[0] for k in runs] == ["transfer_fused", "repack"]
    assert sum(runs.values()) == 2
    assert unit.counters["transfer.repack"] == 1
    assert not any(k.startswith("transfer.redispatch")
                   for k in unit.counters)
    stages = {tt.STAGE_INGEST, tt.STAGE_EXTRACT_DISPATCH,
              tt.STAGE_NOTE_RECORDS, tt.STAGE_APPLY,
              tt.STAGE_SHARD_APPLY.format(0), tt.STAGE_SHARD_FETCH.format(0),
              tt.STAGE_FETCH_JOIN, tt.STAGE_ORIGINALS, tt.STAGE_STYLED,
              tt.STAGE_PACKED_DECODE}
    assert set(unit.spans) == stages | {tt.REQUEST_SPAN}
    assert sum(unit.spans.values()) == pytest.approx(unit.seconds, abs=1e-9)
    assert not unit.profiled


def _reader(name):
    from benchmark import harness
    return harness.load_module(
        os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"), name)


def _units(root, spans, counters, n, monkeypatch, profiled=False):
    """``n`` units of ``root`` run through the recorder, unit i holding
    each span ``spans[name](i)`` seconds (recorded as given) and counters
    ``counters[name](i)``."""
    with monkeypatch.context() as patch:
        patch.setattr(tp, "profiler_active", lambda: profiled)
        for i in range(n):
            with tp.span(root):
                for name, n_counted in counters.items():
                    tp.count(name, n_counted(i))
                for name in spans:
                    with tp.span(name):
                        pass
            unit = _last(root)
            for name, seconds in spans.items():
                unit.spans[name] = seconds(i)
            unit.seconds = sum(s(i) for s in spans.values()) + 1.0


@pytest.mark.parametrize("root,name,spans,counters,want", [
    ("transfer.request", "ingest_ms.serve",
     {"1 ingest (read_midi+get_input)": lambda i: 0.010 * (i + 1)}, {},
     30.0),
    ("transfer.request", "originals_ms.serve",
     {"4 originals decode+write": lambda i: 0.070 + 0.001 * i}, {}, 72.0),
    ("transfer.request", "styled_ms.serve",
     {"6 styled decode+write": lambda i: 0.020,
      "6a packed-job decode (out of 6)": lambda i: 0.001 * i}, {}, 22.0),
    ("transfer.request", "fetch_wait_ms.serve",
     {"5c fetch, shard 0 (out of 5)": lambda i: 0.001 * (i == 4)}, {}, 0.2),
    ("transfer.request", "redispatches.serve", {},
     {"transfer.redispatch.pool": lambda i: int(i < 2),
      "transfer.redispatch.capacity": lambda i: int(i == 0)}, 0.6),
    ("transfer.request", "repacks.serve", {},
     {"transfer.repack": lambda i: int(i % 2 == 0)}, 0.6),
    ("transfer.request", "captures.serve", {},
     {"programs.captures": lambda i: int(i == 3)}, 1),
    ("data.batch", "batch_build_ms.train",
     {"t.build": lambda i: 0.001 * i}, {}, 1002.0),
    ("train.step", "step_host_ms.train",
     {"t.replay": lambda i: 0.002 * i}, {}, 1004.0),
    ("train.step", "captures.train", {},
     {"programs.captures": lambda i: 0}, 0),
])
def test_readers_take_the_window_units(monkeypatch, root, name, spans,
                                       counters, want):
    """Five window units, then three a profiler saw (set far off): each
    reader reads the five. With fewer units than the window, or no
    window, it reads nothing."""
    read = _reader(name).read
    far = {k: (lambda i: 9.0) for k in spans}
    _units(root, spans, counters, 5, monkeypatch)
    _units(root, far, {k: (lambda i: 7) for k in counters}, 3, monkeypatch,
           profiled=True)
    assert read({"window_units": 5}) == pytest.approx(want)
    assert read({"window_units": len(tp.units(root)) + 1}) is None
    assert read({}) is None
