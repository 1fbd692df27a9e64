"""The benchmark's driver: one cell, one run.

``run.py`` calls ``main``. It reads the cell's files by name, checks the
cards, runs the cell's traffic driver (set-up, the measured window, the
comparison with the plain reference) and prints the result: the numbers
compared with their limits as the last lines of standard error, and one
JSON object as the last line of standard output.

Files, each found by the name that ``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the cell's configuration, traffic mix, chips,
  ``why``, and the limits of its comparison (``check``);
- ``configs/<config>.json``: the configuration's widths, policy, weights;
- ``traffic/<mix>.json``: the mix's parameters and its ``driver``;
- ``traffic/<driver>.py``: the driver, a module with ``run(ctx)``;
- ``metrics/<metric>.py``: a per-layer metric, a module with
  ``read(records)`` that returns a number or None.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mst_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A module from a file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port builds its kernels under ``build/mst_torch_kernels``
    itself)."""
    base = os.path.join(ROOT, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


class Cell:
    """A cell's files, read by name."""

    def __init__(self, name: str):
        self.name = name
        self.bench = load_json(os.pardir, "BENCHMARK.json")
        if not any(w["name"] == name for w in self.bench["workloads"]):
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = load_json("workloads", f"{name}.json")
        self.config = load_json("configs", f"{self.workload['config']}.json")
        self.mix = load_json("traffic", f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])

    def applies(self, metric: dict, reported=None) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return reported is None or metric.get("moves") in reported

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self.applies(m)]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"] if self.applies(m, e2e)]


class Context:
    """What a traffic driver gets: the run's arguments, the cell's files,
    a scratch directory under TMPDIR (removed at exit) and the helpers
    below."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 t_start: float):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_start = t_start
        self.scratch = tempfile.mkdtemp(prefix="bench-")

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    def path(self, *parts) -> str:
        return os.path.join(HERE, *parts)

    def close(self) -> None:
        shutil.rmtree(self.scratch, ignore_errors=True)


@contextlib.contextmanager
def traced(ctx: Context, label: str):
    """Trace the block with ``torch.profiler`` (CPU and CUDA activity),
    inside a harness range ``label``; yields a dict that holds, after the
    block, the trace's reduction (``measure.trace.reduce_trace``) over the
    device records of the block and its host wall seconds
    (``window_s``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.measure.trace import load_events, reduce_trace

    out: Dict = {}
    path = os.path.join(ctx.scratch, f"trace-{label}.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(f"bench.{label}"):
            yield out
            torch.cuda.synchronize()
        out["window_s"] = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    events = load_events(path)
    os.remove(path)
    span = [e for e in events if e.get("name") == f"bench.{label}"
            and e.get("ph") == "X"]
    if span:
        t0_us, t1_us = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
        out.update(reduce_trace(events, t0_us, t1_us))
    else:
        out.update(reduce_trace(events))


def require_cards(n: int) -> Optional[str]:
    """None when ``n`` CUDA cards are present, else why not."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on NVIDIA GPUs only"
    if torch.cuda.device_count() < n:
        return (f"the cell needs {n} cards; "
                f"{torch.cuda.device_count()} present")
    return None


def _fmt(x):
    return x if isinstance(x, (int, str)) or x is None else float(x)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda", breaker=None):
    """One run of ``cell``: the result line (a dict) and the checks. The
    benchmark runs it on the card; ``device="cpu"`` drives the same path
    on the CPU with the kernels' plain versions (for tests), and
    ``breaker(program)`` may break the program under test first."""
    import torch

    ctx = Context(cell, seed, seconds, trace, t_start)
    try:
        driver = load_module(
            ctx.path("traffic", f"{cell.mix['driver']}.py"),
            cell.mix["driver"])
        result = driver.run(ctx, device=device, breaker=breaker)
    finally:
        ctx.close()
    if trace:
        metrics = {}
        for m in cell.per_layer():
            reader = load_module(ctx.path("metrics", f"{m['name']}.py"),
                                 m["name"])
            value = reader.read(result["records"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end():
            value = result["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    checks = result["checks"]
    correct = bool(result["correct"]) and all(
        c["value"] <= c["limit"] for c in checks.values())
    on_card = device != "cpu"
    info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(result["memory_peak_bytes"]),
    }
    line = {"correct": correct, "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": info}
    if trace and "trace" in result["records"]:
        reduced = result["records"]["trace"]
        info["busy_s"] = float(reduced.get("busy_s", 0.0))
        info["window_s"] = float(reduced["window_s"])
        line["breakdown"] = {
            "device_ops": [[k, float(v)]
                           for k, v in reduced.get("device_ops", [])],
            "idle_gaps": [[k, float(v)]
                          for k, v in reduced.get("idle_gaps", [])],
        }
    line["checks"] = {k: {"value": _fmt(c["value"]),
                          "limit": _fmt(c["limit"])}
                      for k, c in checks.items()}
    return line


def main(argv, t_start: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs()
    cell = Cell(args.workload)
    why_not = require_cards(cell.chips)
    if why_not is not None:
        print(why_not, file=sys.stderr)
        return 3
    line = execute(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(f"correct: {line['correct']}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
