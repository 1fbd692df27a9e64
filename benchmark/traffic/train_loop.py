"""Traffic driver: the port's training loop over a generated corpus.

The loop of ``train-model-torch.py`` with its defaults: the corpus is
streamed by ``data.pipeline.iter_inputs`` (shuffled, looped, through a
``data.cache.SongCache``), grouped into batches at the trainer's shape
buckets, built on the prefetch thread by
``runtime.train.device_batch_from_songs`` (K1), and trained by the
captured ``runtime.train.make_train_step`` (K2 forward, K3 backward, Adam
every ``iter_size`` micro-steps), each step's losses fetched one step
later and checked finite. The mix's parameters (``traffic/<mix>.json``):

- ``batch``: songs per micro-step; ``corpus``: songs generated in set-up;
  ``sizes``: the generator's overrides for them (beats per bar, bars,
  pitched channels, percussion), the same for every seed;
- ``compare_applies``: the first optimizer applies (of ``iter_size``
  micro-steps each), made in set-up through the window's own step and
  feed, that the reference follows;
- ``warmup``: the least and most further micro-steps, and how many in a
  row must capture no new program, before the window opens;
- ``trace_steps``: micro-steps traced after the window (``--trace 1``).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np


def _corpus(ctx, n, sizes):
    from benchmark.gen import songs
    spec = [dict(numer=s[0], n_bars=s[1], n_pitched=s[2], drums=bool(s[3]))
            for s in sizes]
    seed = int(np.random.SeedSequence(ctx.seed).generate_state(1)[0])
    order = np.random.default_rng(seed).permutation(n)
    data, _ = songs.make_pool(seed, n, sizes=[spec[i] for i in order])
    root = os.path.join(ctx.scratch, "corpus")
    os.makedirs(root)
    files = {}
    for i, blob in enumerate(data):
        path = os.path.join(root, f"gen_{i:04d}.mid")
        with open(path, "wb") as fh:
            fh.write(blob)
        files[path] = blob
    return files


def run(ctx, device: str = "cuda", breaker=None):
    import torch

    from benchmark.reference import train_ref
    from mst_torch.config import Config, ModelConfig, TrainConfig
    from mst_torch.data.cache import SongCache
    from mst_torch.data.pipeline import iter_inputs
    from mst_torch.data.prefetch import prefetch_iterator
    from mst_torch.models import StyleTransferModel
    from mst_torch.runtime import train as tr

    mix, cfg = ctx.cell.mix, ctx.cell.config
    on_card = device != "cpu"
    B = int(mix["batch"])
    t_phase = time.perf_counter()
    files = _corpus(ctx, mix["corpus"], mix["sizes"])
    tcfg = {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["train"].items()}
    config = Config(model=ModelConfig(**cfg["model"]),
                    train=TrainConfig(seed=ctx.seed % (2 ** 32),
                                      batch_size=B, **tcfg))
    t = config.train
    model = StyleTransferModel(config.model)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    init = train_ref.init_state_dict(shapes, ctx.seed, device)
    model.load_state_dict(init)
    init = {k: v.detach().clone() for k, v in init.items()}
    state = tr.create_train_state(config, device=device, model=model)
    if on_card:
        tr.reproducible_backends()
    if breaker is not None:
        breaker(state)

    cache = SongCache(max_bytes=512 << 20)
    songs = iter_inputs(sorted(files), shuffle=True, looped=True,
                        min_n_messages=t.min_n_messages,
                        rng=np.random.default_rng([ctx.seed, 4]),
                        cache=cache)

    def groups():
        """(songs, Cb, Rb, caps) of each micro-step, as the trainer's CLI
        groups them."""
        while True:
            group, caps = [], []
            while len(group) < B:
                _, song = next(songs)
                if song.pitched_empty:
                    continue
                if group and song.beats_per_bar != group[0].beats_per_bar:
                    continue
                group.append(song)
                caps.append(t.max_total_bars // song.n_channels)
            Cb = tr.bucket_shape(max(s.n_channels for s in group),
                                 t.channel_buckets)
            Rb = tr.bucket_shape(max(min(s.n_bars, c)
                                     for s, c in zip(group, caps)),
                                 t.bar_buckets)
            if B > 1:
                Rb = tr.clamp_bar_bucket(Rb, B, Cb, group[0].beats_per_bar,
                                         t.batch_cell_budget, t.bar_buckets)
            caps = [min(c, Rb) for c in caps]
            yield group, Cb, Rb, caps

    def build():
        for group, Cb, Rb, caps in groups():
            batch = tr.device_batch_from_songs(
                group, Cb, Rb, bar_cap=caps, device=device,
                raster_dtype=config.model.storage_dtype)
            meta = ([s.path for s in group], Cb, Rb, caps,
                    group[0].beats_per_bar)
            yield meta, batch

    batches = prefetch_iterator(build(), depth=t.prefetch_depth)
    step_fns = {}

    def step(batch):
        has_u = batch.unpitched is not None
        if has_u not in step_fns:
            step_fns[has_u] = tr.make_train_step(config, has_u,
                                                 capture=on_card)
        return step_fns[has_u](state, batch)[1]

    def graphs():
        return 0 if state.programs is None else len(state.programs.graphs)

    def finite(vec):
        """The fetched loss vector (``LossDict`` order); every component
        must be finite, the unpitched ones (7-10) where they exist."""
        values = vec.cpu().numpy()
        present = np.ones(len(values), bool)
        if np.isnan(values[7]):
            present[7:11] = False
        if not np.all(np.isfinite(values[present])):
            raise FloatingPointError(f"a loss is not finite: {values}")
        return values

    phases = {"process start and imports": t_phase - ctx.t_start,
              "corpus, model and state": time.perf_counter() - t_phase}
    t_phase = time.perf_counter()
    # the compared steps: the window's own call and feed
    compared, losses = [], []
    first_grad = None
    for k in range(mix["compare_applies"] * t.iter_size):
        meta, batch = next(batches)
        losses.append(float(finite(step(batch))[0]))
        compared.append(meta)
        if k + 1 == t.iter_size:
            first_grad = {n: state.optimizer.state[p]["exp_avg"].detach()
                          .clone() / (1.0 - tr.ADAM_BETAS[0])
                          for n, p in state.model.named_parameters()}
    after = {n: p.detach().clone()
             for n, p in state.model.named_parameters()}
    phases["compared steps"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # warm-up until no new program is captured
    w_min, w_max, w_stable = mix["warmup"]
    stable = 0
    for w in range(w_max):
        before = graphs()
        finite(step(next(batches)[1]))
        stable = stable + 1 if graphs() == before else 0
        if w + 1 >= w_min and stable >= w_stable:
            break
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    phases["warm-up steps"] = time.perf_counter() - t_phase
    ctx.note("set-up by phase, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items())
        + f"; programs {graphs()}")

    # the measured window
    captured = graphs()
    n_steps, n_songs, wait = 0, 0, 0.0
    keys = {}
    pending = None
    t0 = time.perf_counter()
    while True:
        w0 = time.perf_counter()
        meta, batch = next(batches)
        wait += time.perf_counter() - w0
        loss = step(batch)
        if pending is not None:
            finite(pending)
        pending = loss
        n_steps += 1
        n_songs += len(meta[0])
        key = (len(meta[0]),) + tuple(meta[1:3]) + (meta[4],
                                                    batch.unpitched is not None)
        keys[key] = keys.get(key, 0) + 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    finite(pending)
    if on_card:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    if graphs() != captured:
        ctx.note(f"{graphs() - captured} program(s) captured inside the "
                 f"window")
    records = {"window_s": window, "window_units": n_steps,
               "batch_wait_ms": 1e3 * wait / n_steps,
               "compute_dtype": config.model.compute_dtype,
               "storage_dtype": config.model.storage_dtype}
    if ctx.trace:
        from benchmark.harness import traced
        rows = []
        with traced(ctx, "steps") as trace:
            for _ in range(mix["trace_steps"]):
                meta, batch = next(batches)
                finite(step(batch))
                rows.append(len(meta[0]) * meta[1] * meta[2] * meta[4] * 10)
        trace["units"] = len(rows)
        records["trace"] = trace
        records["k3_rows"] = rows
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    batches.close()
    served_losses = losses
    delta = {n: after[n] - init[n] for n in after}
    del state, step_fns, batches, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference follows the compared steps
    t_ref = time.perf_counter()
    ref_config = ModelConfig(**cfg["model"])
    ref = train_ref.TrainReference(ref_config, cfg["train"], init, device)
    songs_by_path = {}

    def ref_songs(paths):
        out = []
        for p in paths:
            if p not in songs_by_path:
                songs_by_path[p] = train_ref.ingest(files[p],
                                                    t.min_n_messages)
            out.append(songs_by_path[p])
        return out

    ref_losses, flops_by_key = [], {}
    ref_first = None
    for k, (paths, Cb, Rb, caps, T) in enumerate(compared):
        group = ref_songs(paths)
        batch = train_ref.make_batch(group, Cb, Rb, caps, device)
        ref_losses.append(ref.micro_step(batch))
        if k + 1 == t.iter_size:
            ref_first = ref.first_moment()
            ref_first = {n: v / (1.0 - train_ref.BETAS[0])
                         for n, v in ref_first.items()}
    ref_delta = {n: v - init[n] for n, v in ref.params().items()}
    numbers = train_ref.compare(served_losses, ref_losses, first_grad,
                                ref_first, delta, ref_delta)
    ctx.note(f"reference: {len(compared)} micro-steps in "
             f"{time.perf_counter() - t_ref:.3f} s; losses "
             f"{served_losses} against {ref_losses}; worst leaf's delta "
             f"gap {numbers['worst_leaf_delta_gap']!r}; "
             f"{numbers['leaves_left_out']} leaves left out of delta_gap")
    # FLOPs of every shape the window met, counted on the reference
    for key in keys:
        if key not in flops_by_key:
            flops_by_key[key] = _shape_flops(ref, key, device)
    records["flops_window"] = sum(flops_by_key[k] * n
                                  for k, n in keys.items())
    del ref
    ctx.note(f"window {window:.3f} s, {n_steps} micro-steps, set-up "
             f"{setup_s:.3f} s, shapes {keys}")
    limits = ctx.cell.workload["check"]
    return {
        "correct": True,
        "attempted": n_steps,
        "failed": 0,
        "memory_peak_bytes": memory_peak,
        "end_to_end": {"setup_s": setup_s,
                       "train_songs_per_s": n_songs / window},
        "checks": {name: {"value": numbers[name], "limit": limits[name]}
                   for name in ("loss_gap", "grad_gap", "delta_gap")},
        "records": records,
    }


def _shape_flops(ref, key, device):
    """Matmul FLOPs of one reference micro-step at a batch shape, forward
    and backward (zero inputs: the count depends on the shapes alone;
    counted under fp32 operands, whose count is the same); the reference's
    gradients are cleared after."""
    import torch

    from benchmark.reference import train_ref
    from torch.utils.flop_counter import FlopCounterMode

    B, Cb, Rb, T, has_u = key
    z = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    batch = train_ref.Batch(
        mode=z(B, 2), bpm=z(B) + 120.0, pitched=z(B, Cb, Rb, T, 10, 280),
        instruments_features=z(B, Cb, 51),
        unpitched=z(B, 1, Rb, T, 10, 94) if has_u else None,
        used_instruments=z(B, 41),
        bar_lengths=torch.full((B,), Rb, dtype=torch.int64, device=device),
        channel_mask=z(B, Cb) + 1.0,
        uchannel_mask=z(B, 1) + 1.0 if has_u else None)
    counter = FlopCounterMode(display=False)
    with counter:
        train_ref.loss_fn(ref.model, batch).total.backward()
    ref.model.zero_grad(set_to_none=False)
    return float(counter.get_total_flops())
