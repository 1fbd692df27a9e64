"""A bundle's device programs, each built once per shape key and launched
as one unit.

Counterpart of mst_tpu's jit cache (``ModelBundle.fn``,
mst_tpu/transfer.py:541-604): there a program is compiled once per shape
and dispatched as one executable; here, on the card, it is captured once
as a CUDA graph (``torch.cuda.graph``) and replayed. ``Programs.run(key,
fn, args, statics)`` runs ``fn(*args, **statics)`` as program ``key``:

- On the CPU, or with ``capture=False``, the program runs eagerly; its
  inputs are moved to the device first.
- On the card, the first call of a capture key copies the inputs into
  static buffers, allocated outside the graphs' memory pool; runs the
  program once eagerly on a side stream (the warm-up, where cuBLAS and
  cuDNN set up their handles and K2 sets its kernels' shared-memory
  limits); captures it, on a capture stream of its own card, into the
  pool that all graphs of one ``Programs`` share
  (``torch.cuda.graph_pool_handle()``); and replays it. A later
  call copies its inputs into the static buffers and replays. Host
  inputs (the note records, the job rows) go through pinned memory and a
  copy that does not wait for the card.
- The capture key is the program key, the structure of the inputs, every
  input's shape and dtype, the static arguments, and the precision policy
  in force (mst_torch.ops.precision). The policy is a ``ContextVar`` that
  the program's code reads while it is captured, so its value is baked
  into the graph.
- A failed capture raises. Nothing runs the program eagerly on the card
  in the graph's place.
- A capture checks only its own thread's CUDA calls
  (``capture_error_mode="thread_local"``). The trainer's prefetch thread
  builds the next batch meanwhile, on its own stream and tensors: its
  pageable copies and their stream synchronisation would invalidate a
  capture in the default ``"global"`` mode, which happened on the card
  once a step's eager run became short enough for the build to overlap
  the capture.
- A ``Programs`` belongs to one card, which is the current device while
  any of its programs runs, is captured or replays. A bundle over a mesh
  of cards keeps one per card (mst_torch.transfer).

Sharing one pool. Graphs captured into one private pool may reuse the
memory that an earlier capture freed, its intermediates, for their own
intermediates and static outputs, so the replay of one graph may overwrite
another's static outputs. PyTorch's note on sharing memory across captures
makes that safe by replaying graphs in the order they were captured; the
capacity ladder of mst_torch.transfer replays them in any order. The rule
relied on here instead: (a) the static inputs lie outside the pool, so no
replay writes them; (b) ``run`` copies a replay's outputs out of the pool
(``clone``, on the stream of the replay) before it returns, so before any
other program replays; (c) replays run one at a time on the caller's
stream. What a replay overwrites is then never read again.

Launch counters. The kernel wrappers count a launch in Python
(``raster_kernel.rasterize.launches``, ``grid_kernel.grid_tail.launches``
and the rest), and a replay runs no Python. So the launches a capture
records are taken back from the counters when the capture ends and added
to them on each replay. The warm-up's launches are real and stay counted.

Stateful programs (``run(..., stateful=True)``: the training step of
mst_torch.runtime.train, mst_tpu's jitted step and K-step scan). Such a
program mutates state, so four more rules hold:

- The state lies outside the pool, in tensors allocated before any
  capture: the parameters, their ``.grad`` buffers, Adam's moments and
  step count, and its learning-rate tensor. A replay updates them in
  place, as ``donate_argnums`` lets XLA do.
- A key's first call is the real call: the program runs once, eagerly,
  on the side stream, and its outputs are returned. The capture then only
  records it; later calls replay. (A warm-up followed by a replay would
  apply the step twice.)
- The caller keeps its host bookkeeping (step counters, the schedule's
  counter) out of ``fn``: a capture runs ``fn``'s Python once more.
- The program runs with autograd on, not under ``inference_mode``.

A replayed graph carries no ``record_function`` scope, so a trace cannot
attribute its kernels to model components; the profile tools run the
programs with ``capture=False``.

Each capture counts ``programs.captures`` in the caller's open unit
(mst_torch.runtime.profile).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from mst_torch.ops import (compact_kernel, grid_kernel, lstm_kernel,
                           melody_kernel, precision, raster_kernel)
from mst_torch.runtime.profile import count

# (wrapper, counter attribute) of every kernel form; K5 and K6 have an
# fp32 form alone
COUNTERS = tuple((fn, attr)
                 for fn in (raster_kernel.rasterize, grid_kernel.grid_tail,
                            grid_kernel.grid_tail_bwd,
                            lstm_kernel.lstm_recur,
                            lstm_kernel.lstm_recur_bwd)
                 for attr in ("launches", "launches_bf16")) + (
    (melody_kernel.melody_tail, "launches"),
    (compact_kernel.pack_compact, "launches"))


def _launch_counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in COUNTERS)


def _set_launch_counts(counts) -> None:
    for (fn, attr), n in zip(COUNTERS, counts):
        setattr(fn, attr, n)


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (tuples and lists of leaves) with each
    leaf replaced by its index in ``leaves``, to which it is appended."""
    if isinstance(tree, (tuple, list)):
        return tuple(_flatten(t, leaves) for t in tree)
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(spec, leaves):
    if isinstance(spec, tuple):
        return tuple(_unflatten(s, leaves) for s in spec)
    return leaves[spec]


def _signature(leaf):
    if leaf is None:
        return None
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"program inputs are tensors or None, got "
                        f"{type(leaf).__name__}")
    return tuple(leaf.shape), leaf.dtype


def _load(buf: torch.Tensor, leaf: torch.Tensor) -> None:
    """Copy ``leaf`` into the card's buffer ``buf`` without waiting for
    the card: a host tensor goes through pinned memory (the caching host
    allocator keeps the block until the copy has run)."""
    if leaf.device.type == "cpu":
        leaf = leaf.pin_memory()
    buf.copy_(leaf, non_blocking=True)


@dataclasses.dataclass
class Graph:
    """One captured program: its graph, static input buffers (None where
    the input is None), static outputs and their structure, the launches
    of each kernel form that one replay makes, and what it cost to build
    (the warm-up and the capture, wall seconds)."""

    key: str
    graph: "torch.cuda.CUDAGraph"
    inputs: List[Optional[torch.Tensor]]
    outputs: List[torch.Tensor]
    out_spec: object
    launches: Tuple[int, ...]
    warmup_s: float
    capture_s: float


class Programs:
    """The programs of one bundle on ``device`` and the CUDA graphs
    captured for them (``graphs``, by capture key). ``runs`` counts the
    calls of each program key."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[tuple, Graph] = {}
        self.runs = collections.Counter()
        self._pool = None
        self._stream = None
        self._capture_stream = None

    def run(self, key: str, fn, args, statics: dict, capture: bool,
            stateful: bool = False):
        """``fn(*args, **statics)`` as program ``key`` (see the module's
        docstring), captured on the card when ``capture``. ``args``:
        tensors (on any device) or None, in tuples. ``stateful``: ``fn``
        updates state outside the pool and runs with autograd on (the
        module's "Stateful programs"). Returns the program's output
        tensor(s) on the device."""
        self.runs[key] += 1
        leaves = []
        spec = _flatten(tuple(args), leaves)
        # a card named by its index becomes current; "cuda" is the current
        # card already, and the CPU has none
        on_card = (torch.cuda.device(self.device.index)
                   if self.device.type == "cuda"
                   and self.device.index is not None
                   else contextlib.nullcontext())
        with on_card, (torch.enable_grad() if stateful
                       else torch.inference_mode()):
            if self.device.type != "cuda" or not capture:
                moved = [None if x is None else x.to(self.device)
                         for x in leaves]
                return fn(*_unflatten(spec, moved), **statics)
            ckey = (key, spec, tuple(_signature(x) for x in leaves),
                    tuple(sorted(statics.items())),
                    (precision.compute_dtype(), precision.storage_dtype()))
            graph = self.graphs.get(ckey)
            if graph is None:
                count("programs.captures")
                graph, first = self._capture(key, fn, spec, leaves, statics)
                self.graphs[ckey] = graph
                if stateful:
                    return first
            else:
                for buf, leaf in zip(graph.inputs, leaves):
                    if buf is not None:
                        _load(buf, leaf)
            graph.graph.replay()
            _set_launch_counts(n + d for n, d in zip(_launch_counts(),
                                                     graph.launches))
            return _unflatten(graph.out_spec,
                              [t.clone() for t in graph.outputs])

    def _static_input(self, leaf: torch.Tensor) -> torch.Tensor:
        """A buffer on the card, outside the graphs' pool, holding
        ``leaf``."""
        buf = torch.empty(leaf.shape, dtype=leaf.dtype, device=self.device)
        _load(buf, leaf)
        return buf

    def _capture(self, key, fn, spec, leaves, statics):
        """Run ``fn`` once eagerly on the side stream, then capture it:
        (its ``Graph``, the eager run's outputs)."""
        inputs = [None if x is None else self._static_input(x)
                  for x in leaves]
        args = _unflatten(spec, inputs)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._capture_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            first = fn(*args, **statics)
        current.wait_stream(self._stream)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            # on this card's own stream: torch.cuda.graph's default stream
            # is made once, on the card current at the process's first
            # capture
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._capture_stream,
                                  capture_error_mode="thread_local"):
                out = fn(*args, **statics)
            recorded = tuple(a - b for a, b in zip(_launch_counts(), before))
        except Exception as e:
            raise RuntimeError(f"program {key}: CUDA graph capture "
                               f"failed") from e
        finally:
            _set_launch_counts(before)      # a capture launches nothing
        outputs = []
        out_spec = _flatten(out, outputs)
        return Graph(key=key, graph=graph, inputs=inputs, outputs=outputs,
                     out_spec=out_spec, launches=recorded, warmup_s=t1 - t0,
                     capture_s=time.perf_counter() - t1), first
