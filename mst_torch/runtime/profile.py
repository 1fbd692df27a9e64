"""Profiling tools of the port: always-on spans and counters (``span``,
``count``, ``units``), a wall-clock ``StageTimer``, model-scope
annotations for a trace (``model_scopes``), and ``summarize``, the summary
of a ``runtime.metrics.profiler_trace`` Chrome trace by model component,
by kernel category and by idle gap.

Spans and counters. ``with span(name):`` times a block on the host clock
(``@spanned(name)``: each call of a function).
A span opened on a thread with no span open is a root span, and with all
that opens inside it, one unit: one ``transfer_styles`` request
(``transfer.request``), one training call (``train.step``), one batch
build (``data.batch``). Each thread keeps its own stack of open spans, so a
worker thread's units never nest under the main thread's. A span's self
time is its duration less its children's (``StageTimer``'s rule).
``count(name, n)`` adds to the open unit's counters; with no unit open it
counts nothing.

A finished unit goes into a ring of the last ``RING_UNITS`` units of its
root's name (``units(root)``), holding its spans' self times, its
counters, and whether a ``torch.profiler`` was recording in the process
(started on any thread) when it began. A span that begins while a
profiler records is also a ``torch.profiler.record_function`` range, with
its unit's id as the argument, so a trace's idle gaps name the program's
stages; with no profiler, no range is opened. Spans never synchronize, and none opens
inside a captured program: they mark stage boundaries on the host, a few
dozen a request. ``ENABLED = False`` turns spans and counters off.

Counterpart of tools/parse_profile.py, which reads a jax.profiler trace,
and of tools/profile_transfer.py's StageTimer. The JAX trace names each
device op's model scope (``tf_op``), category (``hlo_category``) and bytes;
a torch trace has none of them. Here:

- a device kernel belongs to the host op that launched it: the kernel's
  ``correlation`` id leads to its ``cudaLaunchKernel`` (or
  ``cuLaunchKernel``) call, and the ranges on that thread around the call
  are its host stack;
- its component is the innermost ``StyleTransferModel.<child>`` range of
  that stack (``model_scopes`` records them). A backward op (an autograd
  node, run by the engine) carries the ``Sequence number`` of the forward
  op that made it: it goes to that forward op's component;
- its category (``_kernel_category``) comes from the kernel's name (K1,
  K2, K3; memcpy and memset are ``copy``), or else from the innermost op
  of its stack that names one (a matmul, a convolution, a copy, the
  optimizer's step), or else from matmul and convolution kernel names;
  everything else is ``elementwise/reduce``;
- no bytes: torch.profiler records none per kernel.

A trace with no device events (a CPU run) is summarized over the CPU ops'
self time, and says so (``"device": "cpu"``); ``summarize(...,
device="cuda")`` raises on such a trace.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import gzip
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

COMPONENT_PREFIX = "StyleTransferModel."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_PREFIX = "autograd::engine::evaluate_function"
STEP_RANGE = "ProfilerStep#"     # the tracer's own range around a step
# the port's CUDA kernels by symbol (mst_torch/csrc); bf16 forms are the
# same templates
KERNEL_SYMBOLS = (("K3", "grid_tail_bwd_kernel"), ("K2", "grid_tail_kernel"),
                  ("K1", "raster_kernel"))
MATMUL_OPS = frozenset((
    "aten::mm", "aten::bmm", "aten::addmm", "aten::addbmm", "aten::baddbmm",
    "aten::matmul", "aten::linear", "aten::mv", "aten::addmv", "aten::dot",
    "aten::_addmm_activation"))
COPY_OPS = frozenset(("aten::copy_", "aten::to", "aten::_to_copy"))
OTHER = "elementwise/reduce"
TOP_OPS = 12
IDLE_GAPS = 10


class StageTimer:
    """Wall time per named stage (tools/profile_transfer.py's StageTimer):
    ``with timer("name"): ...`` adds the block's seconds to
    ``times["name"]``. Stages nest: an inner stage's time is taken out of
    the stage around it, so the stages never count a second twice. On a
    CUDA ``device`` (or a list of devices: a mesh's cards) a stage waits
    for every card at its exit, so it owns the device work it queued;
    ``sync=False`` leaves that work to a later stage. A CUDA device
    without a card raises."""

    def __init__(self, device=None):
        self.times: Dict[str, float] = {}
        self._inner: List[float] = []
        self._sync = None
        if device is not None:
            import torch
            devices = device if isinstance(device, (list, tuple)) \
                else [device]
            cards = list(dict.fromkeys(
                d for d in map(torch.device, devices) if d.type == "cuda"))
            if cards:
                if not torch.cuda.is_available():
                    raise RuntimeError(f"StageTimer: no CUDA device for "
                                       f"{cards[0]}")
                self._sync = lambda: [torch.cuda.synchronize(d)
                                      for d in cards]

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            if sync and self._sync is not None:
                self._sync()
            elapsed = time.perf_counter() - t0
            inner = self._inner.pop()
            self.times[name] = self.times.get(name, 0.0) + elapsed - inner
            if self._inner:
                self._inner[-1] += elapsed


# spans and counters (the module's docstring)
ENABLED = True
RING_UNITS = 8192       # units kept a root name: a 51 s window of 1.5k steps
_local = threading.local()
_unit_ids = itertools.count(1)
_rings: Dict[str, collections.deque] = {}


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) records in this
    process, whichever thread started it."""
    from torch.autograd import profiler
    return profiler._is_profiler_enabled


@dataclasses.dataclass
class Unit:
    """A finished unit: its root span's name and id, its start
    (``time.perf_counter`` seconds) and duration, the self seconds of its
    spans by name (the root's included; spans of one name add up), its
    counters, and whether a profiler recorded when it began."""

    name: str
    id: int
    start: float
    seconds: float
    spans: Dict[str, float]
    counters: Dict[str, int]
    profiled: bool


class _Open:
    """The open unit of a root span."""

    __slots__ = ("id", "profiled", "spans", "counters")

    def __init__(self):
        self.id = next(_unit_ids)
        self.profiled = profiler_active()
        self.spans: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}


class span:
    """``with span(name):`` the block as a span (the module's docstring)."""

    __slots__ = ("name", "start", "parent", "unit", "inner", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not ENABLED:
            self.unit = None
            return self
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.unit = _Open() if self.parent is None else self.parent.unit
        self.inner = 0.0
        self.range = None
        if profiler_active():
            from torch.profiler import record_function
            self.range = record_function(self.name, str(self.unit.id))
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.unit is None:
            return False
        end = time.perf_counter()
        _local.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        elapsed = end - self.start
        unit = self.unit
        unit.spans[self.name] = (unit.spans.get(self.name, 0.0) + elapsed
                                 - self.inner)
        if self.parent is not None:
            self.parent.inner += elapsed
            return False
        ring = _rings.get(self.name)
        if ring is None:
            ring = _rings.setdefault(self.name,
                                     collections.deque(maxlen=RING_UNITS))
        ring.append(Unit(self.name, unit.id, self.start, elapsed,
                         unit.spans, unit.counters, unit.profiled))
        return False


def spanned(name: str):
    """Decorator: every call of the function as the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of this thread's open unit (none open:
    nothing is counted)."""
    stack = _local.__dict__.get("stack")
    if ENABLED and stack:
        counters = stack[0].unit.counters
        counters[name] = counters.get(name, 0) + n


def units(root: str) -> List[Unit]:
    """The finished units of root span ``root`` that the ring holds,
    oldest first."""
    return list(_rings.get(root, ()))


def stage_span(name: str, sync: bool = True) -> span:
    """A request's stage as a span: the ``stage`` hook of
    ``transfer_styles`` and its helpers when nothing times the request.
    ``sync`` is ``StageTimer``'s; a span never synchronizes."""
    return span(name)


def stage_hook(timer: Optional["StageTimer"] = None):
    """A request's ``stage(name, sync=True)`` hook: each stage a ``span``
    (``stage_span``), and with ``timer`` also a stage of that
    ``StageTimer`` (inside the span, so the span holds the timer's
    synchronize)."""
    if timer is None:
        return stage_span

    @contextlib.contextmanager
    def stage(name: str, sync: bool = True):
        with span(name), timer(name, sync):
            yield
    return stage


@contextlib.contextmanager
def model_scopes(model):
    """While open, every child module of ``model`` runs inside a
    ``torch.profiler.record_function("<Model class>.<child name>")`` range
    (forward pre and post hooks), the ranges ``summarize`` reads as
    components. The hooks are removed on exit: outside the block the model
    is unchanged."""
    from torch.profiler import record_function

    local = threading.local()      # each thread's open ranges

    def opened():
        if not hasattr(local, "scopes"):
            local.scopes = []
        return local.scopes

    def enter(label):
        def pre(module, args):
            scope = record_function(label)
            scope.__enter__()
            opened().append(scope)
        return pre

    def leave(module, args, output):
        scopes = opened()
        if scopes:
            scopes.pop().__exit__(None, None, None)

    prefix = type(model).__name__
    handles = []
    try:
        for name, child in model.named_children():
            handles.append(child.register_forward_pre_hook(
                enter(f"{prefix}.{name}")))
            handles.append(child.register_forward_hook(leave,
                                                       always_call=True))
        yield model
    finally:
        for handle in handles:
            handle.remove()


def load_events(trace_dir: str) -> List[dict]:
    """The events of ``trace_dir/trace.json``, the Chrome trace that
    ``runtime.metrics.profiler_trace`` writes (or of a ``.json`` or
    ``.json.gz`` trace file given as the path)."""
    path = trace_dir
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)["traceEvents"]


class _Thread:
    """One host thread's ranges, nested: ``stack_at(ts)`` gives the ranges
    open at ``ts``, outermost first."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.ranges]
        self.parent = []
        open_ = []
        for i, e in enumerate(self.ranges):
            while open_ and _end(self.ranges[open_[-1]]) <= e["ts"]:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def stack_at(self, ts: float) -> List[dict]:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and _end(self.ranges[i]) < ts:
            i = self.parent[i]
        return self.stack_of(i)

    def stack_of(self, i: int) -> List[dict]:
        """Range ``i`` and the ranges around it, outermost first."""
        stack = []
        while i >= 0:
            stack.append(self.ranges[i])
            i = self.parent[i]
        return stack[::-1]

    def op_parent(self, i: int) -> int:
        """The nearest op (not a user range) around range ``i``, or -1."""
        p = self.parent[i]
        while p >= 0 and self.ranges[p].get("cat") != "cpu_op":
            p = self.parent[p]
        return p


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


def _args(e: dict) -> dict:
    return e.get("args") or {}


def _is_backward(e: dict) -> bool:
    return (e["name"].startswith(BACKWARD_PREFIX)
            or (_args(e).get("Fwd thread id") or 0) > 0)


def _scope(stack) -> Optional[str]:
    for e in reversed(stack):
        if e["name"].startswith(COMPONENT_PREFIX):
            return e["name"]
    return None


def _stack_category(stack) -> Optional[str]:
    for e in reversed(stack):
        name = e["name"]
        if name in MATMUL_OPS:
            return "matmul"
        if name.startswith("aten::") and "conv" in name:
            return "conv"
        if name in COPY_OPS:
            return "copy"
        if name.startswith("Optimizer.step"):
            return "optimizer"
    return None


def _kernel_category(name: str, cat: str, stack) -> str:
    """One of K1, K2, K3, matmul, conv, copy, optimizer and
    elementwise/reduce for a device event (``cat`` its trace category)
    launched under the host ``stack`` (outermost first)."""
    for label, symbol in KERNEL_SYMBOLS:
        if symbol in name:
            return label
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    found = _stack_category(stack)
    if found is not None:
        return found
    low = name.lower()
    if "cudnn" in low or "conv" in low:
        return "conv"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "cublas")):
        return "matmul"
    return OTHER


class _Trace:
    """A trace's host threads, launches and forward ops, for attribution."""

    def __init__(self, events):
        by_tid = collections.defaultdict(list)
        self.launches = {}
        forward = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in RANGE_CATS and not e["name"].startswith(STEP_RANGE):
                by_tid[e["tid"]].append(e)
                seq = _args(e).get("Sequence number")
                if seq is not None and not _is_backward(e):
                    forward[seq].append(e)
            elif cat in LAUNCH_CATS and "correlation" in _args(e):
                self.launches[_args(e)["correlation"]] = e
        recorded = {_args(e).get("correlation") for e in events
                    if e.get("cat") in DEVICE_CATS}
        # host launch calls whose device record the tracer lost
        self.unrecorded = collections.Counter(
            e["name"] for c, e in self.launches.items()
            if "Launch" in e["name"] and c not in recorded)
        self.threads = {tid: _Thread(r) for tid, r in by_tid.items()}
        self.forward = {seq: sorted(ops, key=lambda e: e["ts"])
                        for seq, ops in forward.items()}
        # threads by how many ops they ran: the one that ran most is the
        # main thread, asked first what the host did across an idle gap
        self.busiest = sorted(self.threads,
                              key=lambda t: -len(self.threads[t].ranges))

    def stack(self, tid, ts) -> List[dict]:
        thread = self.threads.get(tid)
        return [] if thread is None else thread.stack_at(ts)

    def component(self, stack) -> str:
        """``StyleTransferModel.<child> [fwd|bwd]`` or ``other [fwd|bwd]``
        of work done under the host ``stack``."""
        backward = [e for e in stack if _is_backward(e)]
        if not backward:
            return f"{_scope(stack) or 'other'} [fwd]"
        scope = None
        for e in reversed(backward):
            seq = _args(e).get("Sequence number")
            if seq is None:
                continue
            ops = self.forward.get(seq, [])
            # the latest forward op of that number before the backward op
            i = bisect.bisect_right([op["ts"] for op in ops], e["ts"]) - 1
            if i >= 0:
                op = ops[i]
                scope = _scope(self.stack(op["tid"], op["ts"]) + [op])
            break
        return f"{scope or 'other'} [bwd]"

    def host_at(self, ts) -> str:
        """The host stack open at ``ts`` on the busiest thread that had
        one, outermost first, joined by ' > '."""
        for tid in self.busiest:
            stack = self.threads[tid].stack_at(ts)
            if stack:
                return " > ".join(e["name"] for e in stack)
        return "(no op: Python or idle)"


def _work_items(events, trace: _Trace, device: Optional[str]):
    """``(device, items)``: one item per device event, or per CPU op's self
    time where the trace holds no device events, as ``(ts, dur, stack,
    name, cat)`` with ``stack`` the host ranges it ran under."""
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
    if kernels and device != "cpu":
        items = []
        for e in kernels:
            launch = trace.launches.get(_args(e).get("correlation"))
            stack = ([] if launch is None
                     else trace.stack(launch["tid"], launch["ts"]))
            items.append((e["ts"], e["dur"], stack, e["name"], e["cat"]))
        return "cuda", items
    if device not in (None, "cpu"):
        raise ValueError(f"summarize(device={device!r}): the trace holds "
                         f"no device events")
    items = []
    for thread in trace.threads.values():
        ops = [i for i, e in enumerate(thread.ranges)
               if e.get("cat") == "cpu_op"]
        self_time = {i: thread.ranges[i]["dur"] for i in ops}
        for i in ops:
            p = thread.op_parent(i)
            if p >= 0:
                self_time[p] -= thread.ranges[i]["dur"]
        for i in ops:
            if self_time[i] > 0:
                e = thread.ranges[i]
                items.append((e["ts"], self_time[i], thread.stack_of(i),
                              e["name"], "cpu_op"))
    return "cpu", items


def _top_op(stack, name: str) -> str:
    """The innermost op of ``stack``, or else the kernel's own name without
    its return type, namespace and arguments."""
    for e in reversed(stack):
        if e.get("cat") == "cpu_op":
            return e["name"]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def _idle_gaps(intervals, trace: _Trace):
    """The ``IDLE_GAPS`` longest gaps between the busy intervals, each with
    the host stack open across its middle."""
    intervals = sorted(intervals)
    if not intervals:
        return []
    t0, busy_to = intervals[0][0], intervals[0][1]
    gaps = []
    for start, end in intervals[1:]:
        if start > busy_to:
            gaps.append((start - busy_to, busy_to))
        busy_to = max(busy_to, end)
    gaps.sort(key=lambda g: -g[0])
    return [{"at_ms": (at - t0) / 1e3, "ms": gap / 1e3,
             "host": trace.host_at(at + gap / 2)}
            for gap, at in gaps[:IDLE_GAPS]]


def _per_step_desc(values: dict, n_steps: float) -> dict:
    return {k: v / n_steps for k, v in
            sorted(values.items(), key=lambda kv: -kv[1])}


def summarize(trace_dir: str, n_steps: float, measured_step_s=None,
              flops=None, peak_flops=None,
              device: Optional[str] = None) -> dict:
    """tools/parse_profile.py's summary of a torch trace of ``n_steps``
    steps (or requests). ``flops``: the matmul FLOPs of the traced work,
    counted on a run of its own (``runtime.flops.count_matmul_flops``),
    ``peak_flops`` the card's peak for their dtype
    (``flops.device_peak_flops``); ``measured_step_s`` the step's wall
    time (default its busy time). ``device``: "cuda" requires device
    events, "cpu" summarizes the CPU ops, None takes what the trace holds.
    Times in ms per step, unrounded; ``idle_gaps`` in ms of the trace.
    ``unrecorded_launches``: kernel launches of the host whose device
    record is missing from the trace, by launch call (none is counted
    anywhere else)."""
    events = load_events(trace_dir)
    trace = _Trace(events)
    device, items = _work_items(events, trace, device)
    by_comp = collections.defaultdict(float)
    by_cat = collections.defaultdict(float)
    launches = collections.defaultdict(int)
    by_op = collections.defaultdict(float)
    total_us = 0.0
    for ts, dur, stack, name, cat in items:
        category = _kernel_category(name, cat, stack)
        total_us += dur
        by_comp[trace.component(stack)] += dur
        by_cat[category] += dur
        launches[category] += 1
        by_op[_top_op(stack, name)] += dur
    busy_s = total_us / 1e6
    step_s = measured_step_s or busy_s / n_steps
    top_ops = _per_step_desc(by_op, n_steps)
    if device == "cuda":
        intervals = [(ts, ts + dur) for ts, dur, *_ in items]
    else:      # the outermost ops of every thread
        intervals = [(e["ts"], _end(e)) for t in trace.threads.values()
                     for i, e in enumerate(t.ranges)
                     if e.get("cat") == "cpu_op" and t.op_parent(i) < 0]
    return {
        "device": device,
        "busy_ms_per_step": busy_s / n_steps * 1e3,
        "model_gflops_per_step": (None if flops is None
                                  else flops / n_steps / 1e9),
        "matmul_fraction_of_peak": (
            None if flops is None or peak_flops is None or step_s <= 0
            else flops / n_steps / step_s / peak_flops),
        "by_component_ms": {k: v / 1e3 for k, v in
                            _per_step_desc(by_comp, n_steps).items()},
        "by_category_ms": {k: v / 1e3 for k, v in
                           _per_step_desc(by_cat, n_steps).items()},
        "by_category_launches": {k: launches[k] / n_steps
                                 for k in sorted(launches)},
        "top_ops_ms": {k: v / 1e3 for k, v in
                       list(top_ops.items())[:TOP_OPS]},
        "idle_gaps": _idle_gaps(intervals, trace),
        "unrecorded_launches": dict(trace.unrecorded),
    }
