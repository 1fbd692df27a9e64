"""The readings that each cell's limits are set from, on the card.

    python3 -m benchmark.tests.controls <cell> <seed> [<seed> ...] \
        --control <seed> [<seed> ...]

For each seed of the first list it runs the cell's whole path with a
short window (``harness.execute``) and prints the numbers compared: the
lower readings, from sound runs of the program. For each control seed it
puts the plain reference, one precision step below the configuration's,
in the program's place at the cell's own size, and prints the numbers it
gives: TF32 for an fp32 configuration, e4m3 operands for a bf16 one. A
training cell of batch B > 1 also reads the fault "half of the batch left
out, the mean taken over the rest" in the reference put in the program's
place. Each line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark import harness  # noqa: E402


def program_reading(cell, seed: int, seconds: float, device="cuda"):
    line = harness.execute(cell, seed, seconds, False, time.perf_counter(),
                           device=device)
    return {k: v["value"] for k, v in line["checks"].items()}


def serve_control(cell, seed: int, device="cuda", n_requests=None):
    """The TF32 reference in the program's place on ``n_requests``
    (default: the mix's ``sample``) requests of the seed's plan."""
    import torch

    from benchmark.reference import serve_ref

    ctx = harness.Context(cell, seed, 0.0, False, time.perf_counter())
    try:
        driver = harness.load_module(
            ctx.path("traffic", f"{cell.mix['driver']}.py"),
            cell.mix["driver"])
        mix = cell.mix
        comp = driver._pool(ctx, mix["pool_seeds"][0], mix["pool"],
                            mix["sizes"])
        style = driver._pool(ctx, mix["pool_seeds"][1], mix["pool"],
                             mix["sizes"])
        comp_songs = [serve_ref.ingest(b) for b in comp]
        style_songs = [serve_ref.ingest(b) for b in style]
        n = n_requests or mix["sample"]
        requests = driver.plan_requests(ctx, comp_songs, style_songs,
                                        mix["requests"])
        start = int(np.random.default_rng([seed, 2]).integers(
            len(requests)))
        requests = [requests[(start + k) % len(requests)] for k in range(n)]
        weights = ctx.path(cell.config["weights"]["serve"])
        config = serve_ref.ModelConfig(**cell.config["model"])
        ref = serve_ref.Reference(weights, device, config)
        low = serve_ref.Reference(weights, device, config, tf32=True)
        gap, differ = 0.0, 0
        for k, (c, s) in enumerate(requests):
            cs = [comp_songs[j] for j in c]
            ss = [style_songs[j] for j in s]
            cn = [f"comp_{j}" for j in c]
            sn = [f"style_{j}" for j in s]
            latents, Rs, Cb = low.extract(cs + ss)
            jobs = serve_ref.plan(cn, sn, cs, ss, Rs)
            outs = low.apply(latents, jobs, Cb)
            out_dir = os.path.join(ctx.scratch, f"control{k}")
            serve_ref.write_request(outs, jobs, cs, ss, cn, sn, out_dir)
            v = serve_ref.judge_request(ref, [comp[j] for j in c],
                                        [style[j] for j in s], cn, sn,
                                        out_dir)
            gap = max(gap, v.note_gap)
            differ += v.originals_differ
        del ref, low
        if device != "cpu":
            torch.cuda.empty_cache()
        return {"note_gap": gap, "originals_differ": differ}
    finally:
        ctx.close()


def reference_plan(cell, seed: int, n_steps: int):
    """(corpus bytes by path, the micro-steps' (paths, Cb, Rb, caps, T)):
    the cell's corpus, grouped in a seeded order at the trainer's buckets,
    with the frozen host code alone."""
    from benchmark.reference import serve_ref, train_ref

    ctx = harness.Context(cell, seed, 0.0, False, time.perf_counter())
    try:
        driver = harness.load_module(
            ctx.path("traffic", f"{cell.mix['driver']}.py"),
            cell.mix["driver"])
        files = driver._corpus(ctx, cell.mix["corpus"], cell.mix["sizes"])
    finally:
        ctx.close()
    t = cell.config["train"]
    B = cell.mix["batch"]
    order = np.random.default_rng([seed, 5]).permutation(sorted(files))
    songs = [(p, train_ref.ingest(files[p], t["min_n_messages"]))
             for p in order]
    songs = [(p, s) for p, s in songs if s is not None]
    steps = []
    for k in range(n_steps):
        group = songs[(k * B) % len(songs):][:B]
        caps = [t["max_total_bars"] // s.n_channels for _, s in group]
        Cb = serve_ref.bucket(max(s.n_channels for _, s in group),
                              t["channel_buckets"])
        Rb = serve_ref.bucket(max(min(s.n_bars, c) for (_, s), c
                                  in zip(group, caps)), t["bar_buckets"])
        if B > 1:
            T = group[0][1].beats_per_bar
            allowed = t["batch_cell_budget"] // (B * Cb * T)
            if Rb > allowed:
                Rb = [b for b in t["bar_buckets"] if b <= allowed][-1]
        caps = [min(c, Rb) for c in caps]
        steps.append(([p for p, _ in group], Cb, Rb, caps,
                      group[0][1].beats_per_bar))
    return files, steps


def _follow(ref, files, steps, t, device, half=False):
    from benchmark.reference import train_ref

    losses, first = [], None
    for k, (paths, Cb, Rb, caps, T) in enumerate(steps):
        if half:
            paths, caps = paths[:len(paths) // 2], caps[:len(caps) // 2]
        group = [train_ref.ingest(files[p], t["min_n_messages"])
                 for p in paths]
        losses.append(ref.micro_step(
            train_ref.make_batch(group, Cb, Rb, caps, device)))
        if k + 1 == t["iter_size"]:
            first = {n: v / (1.0 - train_ref.BETAS[0])
                     for n, v in ref.first_moment().items()}
    return losses, first, ref.params()


def train_control(cell, seed: int, device="cuda"):
    """The reference one precision step below the configuration's in the
    program's place (and, for B > 1, the reference with half of each
    batch left out), each against the reference: the numbers compared."""
    import torch

    from benchmark.reference import train_ref

    t = cell.config["train"]
    n = cell.mix["compare_applies"] * t["iter_size"]
    files, steps = reference_plan(cell, seed, n)
    config = train_ref.ModelConfig(**cell.config["model"])
    shapes = {k: v.shape for k, v in
              train_ref.StyleTransferModel(config).state_dict().items()}
    init = train_ref.init_state_dict(shapes, seed, device)
    lowp = "tf32" if config.compute_dtype == "float32" else "fp8"
    runs = {}
    for name, kw in (("reference", {}), ("control", {"lowp": lowp}),
                     ("half_batch", {"half": True})):
        if name == "half_batch" and cell.mix["batch"] < 2:
            continue
        ref = train_ref.TrainReference(config, t, init, device,
                                       lowp=kw.get("lowp"))
        losses, first, params = _follow(ref, files, steps, t, device,
                                        half=kw.get("half", False))
        runs[name] = (losses, first, {k: params[k] - init[k]
                                      for k in params})
        del ref
        if device != "cpu":
            torch.cuda.empty_cache()
    ref = runs.pop("reference")
    out = {}
    for name, (losses, first, delta) in runs.items():
        numbers = train_ref.compare(losses, ref[0], first, ref[1], delta,
                                    ref[2])
        out[name] = {k: numbers[k] for k in ("loss_gap", "grad_gap",
                                             "delta_gap",
                                             "worst_leaf_delta_gap")}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("cell")
    parser.add_argument("seeds", type=int, nargs="*")
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    harness.cache_dirs()
    cell = harness.Cell(args.cell)
    for seed in args.seeds:
        print(json.dumps({"cell": args.cell, "seed": seed, "program":
                          program_reading(cell, seed, args.seconds)}),
              flush=True)
    serve = cell.mix["driver"] == "serve_closed_loop"
    for seed in args.control:
        reading = (serve_control(cell, seed) if serve
                   else train_control(cell, seed))
        print(json.dumps({"cell": args.cell, "seed": seed,
                          "control": reading}), flush=True)


if __name__ == "__main__":
    main()
