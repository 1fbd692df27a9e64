"""Training observability: EMA-smoothed progress display + append-only CSV.

Counterpart of mst_tpu/runtime/metrics.py (parity target: style/utils/
misc.py:17-82, the ProgressBar with momentum-.99 EMA, and style/utils/
data.py:27-46 + train-model.py:143-149, the flattened loss dict to
training.csv, one row per iteration, header on create). The progress line
is written to stderr by hand (the machine with the GPU has no ``tqdm``);
``save_to_csv`` is the append mode of mst_tpu/utils/data.py's.
``profiler_trace`` records a ``torch.profiler`` trace of the steps it
wraps (read by ``runtime.profile.summarize``); ``StepTimer`` times steps
on the host clock, waiting for the card.
"""

from __future__ import annotations

import contextlib
import csv
import math
import os
import sys
import time
from typing import Dict, Optional


def save_to_csv(path, rows) -> None:
    """Append dict rows to a CSV file, with the first row's keys as the
    header, written only when the file is created (utils/data.py:27-46)."""
    rows = list(rows)
    if not rows:
        return
    fresh = not os.path.isfile(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a", encoding="utf-8", newline="") as fh:
        writer = csv.DictWriter(fh, list(rows[0]))
        if fresh:
            writer.writeheader()
        writer.writerows(rows)


class EmaMeter:
    """Biased EMA metric tracker (parity: ProgressBar's update_values,
    utils/misc.py:49-63: sum/seen pairs each decayed by momentum)."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.sums: Dict[str, float] = {}
        self.seen: Dict[str, float] = {}

    def update(self, n: float = 1, **values):
        for key, value in values.items():
            if value is None or (isinstance(value, float) and math.isnan(value)):
                continue
            self.sums[key] = self.sums.get(key, 0.0) * self.momentum + value * n
            self.seen[key] = self.seen.get(key, 0.0) * self.momentum + n

    @property
    def averages(self) -> Dict[str, float]:
        return {k: self.sums[k] / self.seen[k] for k in self.sums}


class ProgressBar:
    """A progress line with the EMA averages as a postfix (parity:
    utils/misc.py:17-82, the unbiased EMA, and auto-close when n_iterations
    is reached). The line is redrawn on ``stream`` at most every
    ``interval`` seconds and when it closes."""

    def __init__(self, n_iterations: Optional[int] = None,
                 momentum: float = 0.99, stream=None, interval: float = 0.5):
        self.n_iterations = n_iterations
        self.meter = EmaMeter(momentum)
        self.avg_values: Dict[str, float] = {}
        self.n = 0
        self.postfix = ""
        self.stream = sys.stderr if stream is None else stream
        self.interval = interval
        self._t0 = time.perf_counter()
        self._drawn = -math.inf
        self.closed = False

    def add(self, n: int = 1, **values):
        self.n += n
        self.meter.update(n, **values)
        self.avg_values = self.meter.averages
        self.postfix = ", ".join(f"{k}: {v:.2f}"
                                 for k, v in self.avg_values.items())
        if self.n == self.n_iterations:
            self.close()
        elif time.perf_counter() - self._drawn >= self.interval:
            self._draw()

    def _draw(self):
        total = "" if self.n_iterations is None else f"/{self.n_iterations}"
        elapsed = time.perf_counter() - self._t0
        self.stream.write(f"\r{self.n}{total} [{elapsed:.1f}s] {self.postfix}")
        self.stream.flush()
        self._drawn = time.perf_counter()

    def close(self):
        if not self.closed:
            self._draw()
            self.stream.write("\n")
            self.stream.flush()
            self.closed = True


class CsvLogger:
    """Append-mode dict-row CSV with header-on-create — a thin stateful
    wrapper over save_to_csv (parity: train-model.py:143-144 feeding
    utils/data.py:27-46)."""

    def __init__(self, path: str):
        self.path = path

    def append(self, **row):
        save_to_csv(self.path, [row])


def flatten_losses(losses) -> Dict[str, float]:
    """LossDict -> the reference's flattened CSV column names
    (flatten_dict(..., reducer='underscore'), train-model.py:148)."""
    out: Dict[str, float] = {}

    def walk(d, path):
        for key, value in d.items():
            name = f"{path}_{key}" if path else key
            if isinstance(value, dict):
                walk(value, name)
            else:
                out[name] = None if value is None else float(value)
    walk(losses.as_nested_dict(), "")
    return out


class StepTimer:
    """Wall-clock per-step timing with a warm-up discard (mst_tpu's
    StepTimer): ``with timer: step()`` appends the step's seconds to
    ``times``. On a CUDA ``device`` entry and exit wait for the card
    (``torch.cuda.synchronize``) before they read the clock: without that
    the host clock measures the enqueue, not the step (the JAX caller
    blocks on its result instead). ``device`` None or the CPU reads the
    clock alone; a CUDA device without a card raises."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.times = []
        self._t0 = None
        self._sync = None
        if device is not None:
            import torch
            device = torch.device(device)
            if device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(f"StepTimer: no CUDA device for "
                                       f"{device}")
                self._sync = lambda: torch.cuda.synchronize(device)

    def __enter__(self):
        if self._sync is not None:
            self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        """Mean of the steps after the warm-up (of all of them when there
        are no more than ``warmup``)."""
        steady = self.times[self.warmup:] or self.times
        return sum(steady) / max(len(steady), 1)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """torch.profiler trace of the wrapped steps, written to
    ``log_dir/trace.json``, a Chrome trace that ``runtime.profile.summarize``
    and tools/parse_profile_torch.py read. The block gets a ``step()`` that
    the caller calls after one warm-up step: the warm-up runs under the
    tracer but stays out of the trace, and the trace holds what follows.
    The warm-up should be a step of the traced kind. A trace without one
    can lose the device record of a kernel launched near its start: on an
    H100, a K1 launch in 2 of 4 traces of two micro-steps, and as often
    after a warm-up of one small kernel, but in none of 4 after one
    warm-up micro-step;
    ``runtime.profile.summarize`` counts such launches as
    ``unrecorded_launches``. A block that never calls ``step()`` raises,
    since its trace would hold nothing. The profiler's own per-op table is
    not built: ``key_averages()`` took 5.3 s of Python over the 97k events
    of one full-width micro-step traced on a CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    warmed = []

    def step():
        if warmed:
            raise RuntimeError("profiler_trace: step() ends the one warm-up "
                               "step; call it once")
        warmed.append(True)
        prof.step()

    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1 << 30),
                 on_trace_ready=write) as prof:
        yield step
        if cuda:
            torch.cuda.synchronize()
        if not warmed:
            raise RuntimeError("profiler_trace: step() was not called after "
                               "the warm-up step: the trace would be empty")
