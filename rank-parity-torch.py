#!/usr/bin/env python
"""Check training over ranks against one process: run train-model-torch.py
on the same global batch under ``torch.distributed.run`` with N ranks and
in one process, and compare their loss logs row by row.

    python rank-parity-torch.py --ranks 4 --batch-size 4
    CUDA_VISIBLE_DEVICES=0 python rank-parity-torch.py --ranks 2 \
        --batch-size 2
    python rank-parity-torch.py --ranks 2 --batch-size 2 --device cpu
    python rank-parity-torch.py --ranks 2 --seq-parallel 2 --batch-size 1

The ranks take their cards and their backend as the trainer does (card
``LOCAL_RANK`` modulo the cards; ``mst_torch.parallel.default_backend``).
Prints each run's wall time, process starts included, and the largest
relative difference over every logged loss; exits 1 if a run fails, the
logs differ in their rows, or a difference exceeds ``--rtol`` (1e-5, the
fp32 training tolerance of PERF.md §2). ``--root`` runs the trainer of
another checkout (a parent commit's, say) with the same comparison.
"""

import argparse
import csv
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ranks", type=int, required=True)
    parser.add_argument("--batch-size", type=int, required=True,
                        help="the global batch; the ranks must divide it")
    parser.add_argument("--seq-parallel", type=int, default=1,
                        help="ranks on the bar axis of the run over ranks "
                             "(the trainer's --seq-parallel)")
    parser.add_argument("--iters", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--root", default=HERE,
                        help="the checkout whose train-model-torch.py runs")
    parser.add_argument("--data", default=None,
                        help="corpus directory (default: the root's "
                             "mst_torch/assets/smoke)")
    parser.add_argument("--out", default=os.path.join(HERE, "build",
                                                      "rank_parity"),
                        help="where the logs, CSVs and snapshots go")
    parser.add_argument("--rtol", type=float, default=1e-5)
    parser.add_argument("--timeout", type=float, default=600,
                        help="seconds each run may take")
    return parser.parse_args(argv)


def run(args, name, ranks, seq=1):
    """One training run; returns (exit code, wall seconds, CSV path)."""
    root = os.path.abspath(args.root)
    out = os.path.join(os.path.abspath(args.out), name)
    os.makedirs(out, exist_ok=True)
    cli = [os.path.join(root, "train-model-torch.py"),
           "--data", args.data or os.path.join(root, "mst_torch", "assets",
                                               "smoke"),
           "--device", args.device, "--iters", str(args.iters),
           "--batch-size", str(args.batch_size), "--save-interval", "1000",
           "--csv", os.path.join(out, "losses.csv"),
           "--snapshots", os.path.join(out, "snapshots"),
           "--seq-parallel", str(seq)]
    if os.path.exists(os.path.join(out, "losses.csv")):
        os.remove(os.path.join(out, "losses.csv"))
    launcher = [sys.executable]
    if ranks > 1:
        launcher += ["-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", str(ranks)]
    t0 = time.perf_counter()
    with open(os.path.join(out, "run.log"), "w") as log:
        try:
            rc = subprocess.run(launcher + cli, cwd=root, stdout=log,
                                stderr=subprocess.STDOUT,
                                timeout=args.timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    return rc, time.perf_counter() - t0, os.path.join(out, "losses.csv")


def largest_difference(path_a, path_b):
    """(rows of a, rows of b, largest relative difference of a logged loss
    of b from a's)."""
    rows = []
    for path in (path_a, path_b):
        with open(path) as fh:
            rows.append(list(csv.DictReader(fh)))
    worst = 0.0
    for a, b in zip(*rows):
        if a.keys() != b.keys() or a["iteration"] != b["iteration"]:
            return len(rows[0]), len(rows[1]), float("inf")
        for key in a:
            if key != "iteration" and a[key] not in ("", "nan"):
                x, y = float(a[key]), float(b[key])
                worst = max(worst, abs(y - x) / max(abs(x), 1e-12))
    return len(rows[0]), len(rows[1]), worst


def main(argv=None):
    args = parse_args(argv)
    label = f"{args.ranks}x{args.batch_size}"
    if args.seq_parallel > 1:
        label += f"-seq{args.seq_parallel}"
    rc_n, wall_n, csv_n = run(args, f"ranks-{label}", args.ranks,
                              args.seq_parallel)
    rc_1, wall_1, csv_1 = run(args, f"one-{label}", 1)
    print(f"{args.ranks} ranks (--seq-parallel {args.seq_parallel}): exit "
          f"{rc_n}, {wall_n:.3f} s wall; one process: exit {rc_1}, "
          f"{wall_1:.3f} s wall (global batch {args.batch_size}, "
          f"{args.iters} iterations, {args.root})")
    if rc_n != 0 or rc_1 != 0:
        print(f"a run failed: see {os.path.abspath(args.out)}")
        return 1
    n_1, n_n, worst = largest_difference(csv_1, csv_n)
    print(f"{args.ranks} ranks against one process: rows {n_n}/{n_1}, "
          f"largest relative loss difference {worst!r} (rtol {args.rtol})")
    return 0 if n_1 == n_n == args.iters and worst <= args.rtol else 1


if __name__ == "__main__":
    sys.exit(main())
