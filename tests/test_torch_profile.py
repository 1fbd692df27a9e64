"""The port's profiling tools (mst_torch.runtime.profile and
tools/*_torch.py) on the CPU.

- ``summarize`` against tools/parse_profile.py's on one numpy-seeded set of
  device ops, written once as a jax.profiler trace and once as a torch
  Chrome trace: the same busy time and ms per component (the JAX label
  ``StyleTransferModel.x/ [fwd]`` is the port's ``StyleTransferModel.x
  [fwd]``), within 1e-9 relative, in the same order. Durations lie on the
  grid that the JAX summary rounds to (0.01 ms a step), so its rounding
  loses nothing;
- a real CPU trace of a narrow training micro-step pair under
  ``model_scopes``: every child of the model under [fwd] and [bwd], and
  the component and category sums equal to the total;
- tools/profile_transfer_torch.py at tests/test_torch_transfer.py's size:
  the files of ``transfer_styles``, byte for byte, and the JAX tool's six
  stages;
- ``StageTimer``'s nesting, and ``profiler_trace``'s warm-up step, which
  stays out of the trace and which a block must end once.
"""

import gzip
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from mst_torch.runtime import profile as tp
from tests.test_torch_model import NARROW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
SUBS = ("melody_encoder", "style_encoder", "pitched_style_applier",
        "song_info_model", None)
KERNELS = ("void raster_kernel<float>(int const*)",
           "void grid_tail_kernel<0, false>(float const*)",
           "void grid_tail_bwd_kernel<0, true>(float const*)",
           "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16",
           "void at::native::vectorized_elementwise_kernel<4>()")
N_STEPS = 2


def _fixture_ops(seed=0, n=60):
    """(component child or None, phase, kernel, µs) of n device ops. Each
    duration is a multiple of N_STEPS x 10 µs, so every per-step sum lies
    on the JAX summary's 0.01 ms grid."""
    rng = np.random.default_rng(seed)
    return [(SUBS[rng.integers(len(SUBS))],
             "bwd" if rng.random() < 0.4 else "fwd",
             KERNELS[rng.integers(len(KERNELS))],
             int(rng.integers(1, 400)) * 10 * N_STEPS) for _ in range(n)]


def _jax_trace(ops, directory):
    """tools/parse_profile.py's input: a jax.profiler .trace.json.gz whose
    ops carry hlo_category, device_duration_ps and tf_op."""
    events, ts = [], 0.0
    for sub, phase, _, us in ops:
        scope = f"StyleTransferModel.{sub}/" if sub else "add"
        tf_op = ("jit(train_step)/" + (f"transpose(jvp({scope}))"
                                       if phase == "bwd" else scope))
        events.append({"ph": "X", "name": "fusion", "pid": 1, "tid": 1,
                       "ts": ts, "dur": us, "args": {
                           "hlo_category": "loop fusion",
                           "device_duration_ps": str(us * 1_000_000),
                           "tf_op": tf_op}})
        ts += us + 3
    path = os.path.join(directory, "plugins", "profile", "run")
    os.makedirs(path)
    with gzip.open(os.path.join(path, "host.trace.json.gz"), "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def _torch_trace(ops, directory):
    """The same ops as a torch Chrome trace: each kernel launched by a
    forward op inside its scope (thread 11), or by the autograd node of
    such an op on the engine's thread (12), linked by correlation id and
    sequence number. The last launch has no device record."""
    events, t = [], 1000.0

    def ev(cat, name, tid, ts, dur, **args):
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 1,
                       "tid": tid, "ts": ts, "dur": dur, "args": args})

    for i, (sub, phase, kernel, us) in enumerate(ops):
        seq = corr = i + 1
        if sub:
            ev("user_annotation", f"StyleTransferModel.{sub}", 11, t, 8.0)
        ev("cpu_op", "aten::mm", 11, t + 1, 6.0,
           **{"Sequence number": seq, "Fwd thread id": 0})
        if phase == "fwd":
            ev("cuda_runtime", "cudaLaunchKernel", 11, t + 2, 1.0,
               correlation=corr)
        else:
            ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
               12, t + 10, 6.0, **{"Sequence number": seq,
                                   "Fwd thread id": 1})
            ev("cuda_runtime", "cudaLaunchKernel", 12, t + 11, 1.0,
               correlation=corr)
        ev("kernel", kernel, 7, t + 20, float(us), correlation=corr)
        t += 20 + us + 5
    # a launch whose device record the tracer lost
    ev("cuda_runtime", "cudaLaunchCooperativeKernel", 11, t, 1.0,
       correlation=len(ops) + 1)
    os.makedirs(directory)
    with open(os.path.join(directory, "trace.json"), "w") as fh:
        json.dump({"traceEvents": events}, fh)


def test_summary_matches_parse_profile(tmp_path):
    sys.path.insert(0, TOOLS)
    import parse_profile

    ops = _fixture_ops()
    _jax_trace(ops, str(tmp_path / "jax"))
    _torch_trace(ops, str(tmp_path / "torch"))
    want = parse_profile.summarize(str(tmp_path / "jax"), N_STEPS)
    got = tp.summarize(str(tmp_path / "torch"), N_STEPS)
    assert got["device"] == "cuda"
    assert got["busy_ms_per_step"] == pytest.approx(want["busy_ms_per_step"],
                                                    rel=1e-9)
    want_comp = {k.replace("/ [", " ["): v[0]
                 for k, v in want["by_component_ms_gb"].items()}
    assert list(got["by_component_ms"]) == list(want_comp)
    for key, ms in want_comp.items():
        assert got["by_component_ms"][key] == pytest.approx(ms, rel=1e-9)
    # the categories: K1-K3 and the GEMM by name; the elementwise kernel
    # by its launching op (aten::mm in the forward, the autograd node, no
    # category, in the backward)
    kinds = dict(zip(KERNELS, ("K1", "K2", "K3", "matmul")))
    launches = {}
    for _, phase, kernel, _ in ops:
        kind = kinds.get(kernel, "matmul" if phase == "fwd" else tp.OTHER)
        launches[kind] = launches.get(kind, 0) + 1
    assert got["by_category_launches"] == {
        k: v / N_STEPS for k, v in sorted(launches.items())}
    assert sum(got["by_category_ms"].values()) == pytest.approx(
        got["busy_ms_per_step"], rel=1e-12)
    assert got["unrecorded_launches"] == {"cudaLaunchCooperativeKernel": 1}
    # the gap between two kernels is the host's 25 µs between them
    assert [g["ms"] for g in got["idle_gaps"]] == pytest.approx(
        [0.025] * len(got["idle_gaps"]))


def _write_song(tmp_path, seed):
    sys.path.insert(0, TOOLS)
    from make_corpus import generate_song
    from mst_torch.io import create_midi, native

    info, instruments = generate_song(np.random.default_rng(seed))
    path = str(tmp_path / f"song{seed}.mid")
    native.write_midi_file(path, create_midi(info, *instruments))
    return path


def test_cpu_trace_of_a_micro_step_pair(tmp_path):
    """Two narrow micro-steps (the first applies Adam) of a song with
    percussion, traced under model_scopes after a warm-up micro-step: each child of the model shows
    under [fwd] and [bwd], and components and categories each add up to
    the busy time. The model has no hooks left after the block, and a
    summary that asks for the card refuses a trace without it."""
    from mst_torch.config import Config, ModelConfig
    from mst_torch.runtime import train as tr
    from mst_torch.runtime.metrics import profiler_trace
    from mst_torch.transfer import get_model_input

    config = Config(model=ModelConfig(**NARROW))
    t = config.train
    song = get_model_input(_write_song(tmp_path, 0))[1]
    Rb = tr.bucket_shape(song.n_bars, t.bar_buckets)
    batch = tr.device_batch_from_songs(
        [song], tr.bucket_shape(song.n_channels, t.channel_buckets), Rb,
        bar_cap=[Rb], device="cpu")
    assert batch.unpitched is not None
    state = tr.create_train_state(config, device="cpu", seed=0)
    step = tr.make_train_step(config, True)
    trace = str(tmp_path / "trace")
    with profiler_trace(trace) as end_warmup, \
            tp.model_scopes(state.model):
        state, _ = step(state, batch)       # the tracer's warm-up
        end_warmup()
        for _ in range(2):
            state, _ = step(state, batch)
    assert (state.micro_step, state.opt_step) == (3, 1)
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in state.model.modules())

    got = tp.summarize(trace, 2)
    assert got["device"] == "cpu"
    for name, _ in state.model.named_children():
        for phase in ("fwd", "bwd"):
            assert f"StyleTransferModel.{name} [{phase}]" in \
                got["by_component_ms"], (name, phase)
    busy = got["busy_ms_per_step"]
    assert sum(got["by_component_ms"].values()) == pytest.approx(busy,
                                                                 rel=1e-9)
    assert sum(got["by_category_ms"].values()) == pytest.approx(busy,
                                                                rel=1e-9)
    assert {"matmul", "conv", "copy", "optimizer"} <= \
        set(got["by_category_ms"])
    assert got["idle_gaps"]
    with pytest.raises(ValueError, match="no device events"):
        tp.summarize(trace, 2, device="cuda")


def test_stage_timer_nests_and_needs_the_card(monkeypatch):
    timer = tp.StageTimer()
    with timer("outer"):
        with timer("inner"):
            sum(range(100000))
    with timer("inner"):
        pass
    assert set(timer.times) == {"outer", "inner"}
    assert all(v >= 0 for v in timer.times.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.StageTimer("cuda")


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_stage_tool_writes_the_request_files(tmp_path):
    """tools/profile_transfer_torch.py --device cpu on two compositions and
    one style (tests/test_torch_transfer.py's songs, the snapshot
    weights): its files equal transfer_styles's byte for byte, and its
    stages hold the JAX tool's six."""
    sys.path.insert(0, TOOLS)
    import profile_transfer_torch

    from mst_torch.transfer import ModelBundle, transfer_styles

    comps = [_write_song(tmp_path, s) for s in (0, 245)]
    styles = [_write_song(tmp_path, 235)]
    out = str(tmp_path / "tool")
    result = profile_transfer_torch.main(
        ["--device", "cpu", "--rounds", "1", "--out", out,
         "--compositions", *comps, "--styles", *styles])
    want = transfer_styles(ModelBundle.from_npz(device="cpu"), comps, styles,
                           str(tmp_path / "plain"))
    got = _tree_bytes(os.path.join(out, "staged_0"))
    plain = _tree_bytes(str(tmp_path / "plain"))
    assert sorted(plain) == sorted(os.path.relpath(p, tmp_path / "plain")
                                   for p in want)
    assert got == plain
    with open(os.path.join(TOOLS, "profile_transfer.py")) as fh:
        jax_stages = re.findall(r'st\("([^"]+)"\)', fh.read())
    assert len(jax_stages) == 6
    assert set(jax_stages) <= set(result["stages_ms"])
    assert all(ms >= 0 for ms in result["stages_ms"].values())
    assert result["stage_sum_ms"] <= result["staged_ms"]


def test_profiler_trace_leaves_its_warmup_out(tmp_path):
    """The step before ``step()`` runs under the tracer but is not in the
    trace. ``summarize`` leaves the tracer's step range out of the host
    stacks."""
    from mst_torch.runtime.metrics import profiler_trace

    trace = str(tmp_path / "trace")
    with profiler_trace(trace) as step:
        with torch.profiler.record_function("first step"):
            torch.ones(4).sum()
        step()
        with torch.profiler.record_function("second step"):
            torch.ones(4).sum()
    names = {e["name"] for e in tp.load_events(trace)}
    assert "second step" in names
    assert "first step" not in names
    assert any(n.startswith(tp.STEP_RANGE) for n in names)
    ranges = tp._Trace(tp.load_events(trace)).threads.values()
    assert not any(e["name"].startswith(tp.STEP_RANGE)
                   for thread in ranges for e in thread.ranges)


@pytest.mark.parametrize("calls", [0, 2])
def test_profiler_trace_needs_one_warmup_step(tmp_path, calls):
    """A block that never ends its warm-up would write an empty trace, and
    one that calls ``step()`` twice would trace less than it asked: both
    raise."""
    from mst_torch.runtime.metrics import profiler_trace

    with pytest.raises(RuntimeError, match="step()"):
        with profiler_trace(str(tmp_path / "trace")) as step:
            for _ in range(calls):
                torch.ones(4).sum()
                step()
