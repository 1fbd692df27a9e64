#!/usr/bin/env python3
"""What the port's spans and counters (mst_torch.runtime.profile) cost.

Runs benchmark cells (``benchmark/``, ``harness.execute``) on the card,
each run in a process of its own, with the recorder on and off in turns
(on, off, then off, on, ...), each pair with a seed of its own that both
sides share. For each run it prints ``correct`` and the metrics of the
cell's result line: with ``--trace 0`` the end-to-end metrics
(``setup_s``, ``gpu_ms_per_job``, ``train_songs_per_s``), with
``--trace 1`` the per-layer ones (the serve cell's ``request_p90_ms.serve``
among them). Then, per cell and metric, the medians of each side and the
differences of the pairs. It also times one span on the host, with the
recorder on and off.

    python3 tools/span_overhead_torch.py --pairs 3 --seconds 20 \\
        --trace 0 --cells serve.fp32.r3x3 train.fp32.b1 \\
        --out span_overhead.json

Run from the root of a checkout, on a machine with an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# as benchmark/run.py: the host's math libraries on one thread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def span_cost_us(n: int = 200_000):
    """Host µs of one empty span inside a unit, with the recorder on and
    off (the median of 5 rounds of ``n``)."""
    from mst_torch.runtime import profile

    out = {}
    for on in (True, False):
        profile.ENABLED = on
        rounds = []
        for _ in range(5):
            with profile.span("overhead.unit"):
                t0 = time.perf_counter()
                for _ in range(n):
                    with profile.span("overhead.span"):
                        pass
                rounds.append((time.perf_counter() - t0) / n * 1e6)
        out["on" if on else "off"] = statistics.median(rounds)
    profile.ENABLED = True
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             on: bool) -> dict:
    """One run of cell ``name`` (``harness.execute``) with the recorder on
    or off: its ``correct`` and the metrics of its result line."""
    from benchmark import harness
    from mst_torch.runtime import profile

    profile.ENABLED = on
    line = harness.execute(harness.Cell(name), seed, seconds, trace,
                           time.perf_counter())
    row = {"cell": name, "seed": seed, "recorder": "on" if on else "off",
           "correct": line["correct"]}
    row.update({k: m["value"] for k, m in line["metrics"].items()})
    return row


def summarize(rows):
    """Per cell and metric that both sides read: each side's median and
    the pairs' differences (on minus off), as a share of the off side's
    median too."""
    out = {}
    for name in dict.fromkeys(r["cell"] for r in rows):
        mine = [r for r in rows if r["cell"] == name]
        keys = [k for k in mine[0] if k not in ("cell", "seed", "recorder",
                                                 "correct")]
        for key in keys:
            if not all(key in r for r in mine):
                continue
            on = [r[key] for r in mine if r["recorder"] == "on"]
            off = [r[key] for r in mine if r["recorder"] == "off"]
            by_seed = {}
            for r in mine:
                by_seed.setdefault(r["seed"], {})[r["recorder"]] = r[key]
            diffs = [v["on"] - v["off"] for v in by_seed.values()
                     if len(v) == 2]
            med_off = statistics.median(off)
            out[f"{name}:{key}"] = {
                "on": on, "off": off, "median_on": statistics.median(on),
                "median_off": med_off, "pair_diffs": diffs,
                "median_diff_pct": 100 * statistics.median(diffs) / med_off,
                "off_spread_pct": spread_pct(off)}
    return out


def spread_pct(values):
    """The distance of the first and third quartiles over the median, %."""
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return 100 * (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", nargs="+",
                        default=["serve.fp32.r3x3", "train.fp32.b1"])
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 1717)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--run", nargs=3, metavar=("CELL", "SEED", "ON"),
                        help="one run in this process (what each of the "
                             "runs above is): its row as the last line")
    args = parser.parse_args(argv)

    from benchmark import harness
    harness.cache_dirs()
    why_not = harness.require_cards(1)
    if why_not is not None:
        print(why_not, file=sys.stderr)
        return 3
    if args.run:
        cell, seed, on = args.run
        print(json.dumps(run_cell(cell, int(seed), args.seconds,
                                  bool(args.trace), on == "on")), flush=True)
        return 0
    rows = []
    for name in args.cells:
        for k in range(args.pairs):
            for on in ((True, False) if k % 2 == 0 else (False, True)):
                done = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--seconds",
                     str(args.seconds), "--trace", str(args.trace), "--run",
                     name, str(args.seed + k), "on" if on else "off"],
                    stdout=subprocess.PIPE, text=True, check=True)
                row = json.loads(done.stdout.strip().splitlines()[-1])
                rows.append(row)
                print(json.dumps(row), flush=True)
    result = {"span_us": span_cost_us(), "runs": rows,
              "summary": summarize(rows)}
    print(json.dumps({"span_us": result["span_us"]}))
    for key, s in result["summary"].items():
        print(f"{key}: on {s['median_on']!r}, off {s['median_off']!r}, "
              f"pair diffs {s['pair_diffs']!r} "
              f"({s['median_diff_pct']:+.3f}% median); off spread "
              f"{s['off_spread_pct']!r}%")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
