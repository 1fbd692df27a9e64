#!/usr/bin/env python
"""Train the style-transfer model with the PyTorch port (mst_torch), on the
GPU by default. The counterpart of train-model.py, with the same loop.

Defaults reproduce the reference run: 5000 iterations of one song each,
gradient accumulation 2, Adam(0.01) with StepLR(200, 0.9), EMA progress
display, a CSV loss log, snapshots every 100 iterations
(train-model.py:33-60,89-160). Each step's rasters are built on the device
by the K1 kernel; the pitched applier's note-grid tail runs forward through
K2 and backward through K3.

    python train-model-torch.py --data corpus/ --iters 5000
    python train-model-torch.py --data corpus/ --device cpu --iters 4
    python train-model-torch.py --data corpus/ --storage-dtype bfloat16 \
        --compute-dtype bfloat16

On the card each training step runs as a program captured once per
shape key as a CUDA graph and replayed (mst_torch.runtime.train, the
counterpart of the JAX package's jitted step); ``--no-capture`` runs the
same step eagerly, op by op. Over a process mesh, and with
``--profile-dir`` (a replay carries no ``record_function`` scope), the
step runs with capture off, and the trainer says so. On the CPU the step
always runs eagerly.

``--storage-dtype bfloat16`` stores the raster and the grid-scale
activations as bf16 (K1 writes the bf16 raster; the tail runs the bf16
forms of K2 and K3); ``--compute-dtype bfloat16`` rounds every matmul and
conv operand to bf16 with fp32 accumulation. Parameters, gradients and the
Adam state stay fp32 under both.

Snapshots go to ``torch_snapshots/`` and the loss log to
``torch_training.csv`` by default (``snapshots/`` and ``training.csv`` hold
the JAX package's run); ``mst_torch.transfer.ModelBundle.from_checkpoint``
loads a snapshot for style transfer.

Data-parallel training over ranks, one process each, each on card
``LOCAL_RANK`` (modulo the cards present):

    torchrun --nproc-per-node 4 train-model-torch.py --data corpus/ \
        --batch-size 8
    torchrun --nproc-per-node 2 train-model-torch.py --data corpus/ \
        --device cpu --batch-size 2

Every rank runs the same seeded song stream, so the global batch is the
one-process ``--batch-size N`` batch; each rank builds and trains on its
own N/ranks rows of it (the losses and gradients are the global batch's),
and rank 0 alone writes the CSV and the snapshots. The collectives run
over NCCL, or over gloo on the CPU and where ranks share a card
(``mst_torch.parallel.default_backend``).

``--seq-parallel M`` shards the bar axis as well: the ranks form a
(ranks/M) x M grid, and each holds its rows' bars ``s*R/M .. (s+1)*R/M``
of every raster and activation (the bar-sharded model,
mst_torch.ops.seq_context); M must divide every bar bucket a batch takes:

    torchrun --nproc-per-node 2 train-model-torch.py --data corpus/ \
        --device cpu --seq-parallel 2
    torchrun --nproc-per-node 4 train-model-torch.py --data corpus/ \
        --seq-parallel 2 --batch-size 2
"""

import argparse
import contextlib
import dataclasses
import glob
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default="data/Lakh MIDI Dataset/clean_midi/",
                        help="corpus directory (searched for **/*.mid)")
    parser.add_argument("--iters", type=int, default=5000)
    parser.add_argument("--csv", default="torch_training.csv")
    parser.add_argument("--snapshots", default="torch_snapshots/")
    parser.add_argument("--save-interval", type=int, default=100)
    parser.add_argument("--seed", type=int, default=108)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; without a GPU "
                             "this raises unless --device cpu is given)")
    parser.add_argument("--exact-shapes", action="store_true",
                        help="train on exact per-song shapes from the host "
                             "raster (the reference's behavior) instead of "
                             "padded shape buckets rasterized on the device")
    parser.add_argument("--no-capture", action="store_true",
                        help="run each training step eagerly instead of "
                             "as a captured CUDA graph (the card's default)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest snapshot if present")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of iterations "
                             "11-15 (iteration 10 warms the tracer up), "
                             "with the model's components annotated")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="songs per step over all ranks (>1: padded "
                             "fixed-shape batch; the reference trains one "
                             "song per step); the ranks must divide it")
    parser.add_argument("--seq-parallel", type=int, default=1,
                        help="ranks on the bar axis: each holds 1/N of "
                             "every song's bars (the bar buckets must be "
                             "divisible by it); the ranks must be a "
                             "multiple of it")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the forward in backward "
                             "(torch.utils.checkpoint)")
    parser.add_argument("--compute-dtype", default=None,
                        choices=("float32", "bfloat16"),
                        help="matmul and conv operand dtype (parameters and "
                             "gradients stay float32). Default: "
                             "ModelConfig.compute_dtype")
    parser.add_argument("--storage-dtype", default=None,
                        choices=("float32", "bfloat16"),
                        help="activation storage dtype: bfloat16 stores the "
                             "raster and the grid-scale activations at half "
                             "width (parameters, gradients, the optimizer "
                             "and the loss reductions stay float32). "
                             "Default: ModelConfig.storage_dtype")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="stack this many consecutive same-bucket steps "
                             "into one raster build and one loss fetch")
    parser.add_argument("--bucket-window", type=int, default=0,
                        help="reorder this many consecutive songs so same-"
                             "shape-bucket songs form full stacks (needs "
                             "--steps-per-dispatch>1 and batch size 1). "
                             "Every song is still visited once per epoch; "
                             "a resume mid-window re-trains at most "
                             "window-1 songs. 0 keeps the shuffled order")
    parser.add_argument("--cache-mb", type=int, default=512,
                        help="host-RAM budget (MB) for the cross-epoch "
                             "ingestion cache; 0 re-parses every epoch")
    args = parser.parse_args(argv)
    if args.seq_parallel < 1:
        raise SystemExit("--seq-parallel must be at least 1")
    if args.steps_per_dispatch > 1 and args.exact_shapes:
        raise SystemExit("--steps-per-dispatch needs bucketed shapes "
                         "(drop --exact-shapes)")
    if args.bucket_window:
        if args.steps_per_dispatch <= 1:
            raise SystemExit("--bucket-window only helps stacked steps "
                             "(set --steps-per-dispatch)")
        if args.batch_size != 1:
            raise SystemExit("--bucket-window needs --batch-size 1 (group "
                             "resume cursors only track the last song)")
    return args


def main(argv=None):
    args = parse_args(argv)

    import torch.distributed as dist

    from mst_torch.parallel import initialize_multihost

    own_group = not dist.is_initialized()
    if not initialize_multihost(device=args.device):
        return train(args)
    try:
        return train(args, distributed=True)
    finally:
        if own_group:
            dist.destroy_process_group()


def train(args, distributed=False):
    import numpy as np
    import torch
    import torch.distributed as dist

    from mst_torch.config import Config, MeshConfig, TrainConfig
    from mst_torch.data.pipeline import iter_inputs
    from mst_torch.data.prefetch import prefetch_iterator
    from mst_torch.ops.losses import LossDict
    from mst_torch.runtime import train as tr
    from mst_torch.runtime.checkpoint import CheckpointManager
    from mst_torch.runtime.metrics import (CsvLogger, ProgressBar,
                                           flatten_losses, profiler_trace)
    from mst_torch.runtime.profile import model_scopes
    from mst_torch.transfer import resolve_device

    config = Config(train=TrainConfig(n_iterations=args.iters, seed=args.seed,
                                      save_interval=args.save_interval,
                                      remat=args.remat),
                    mesh=MeshConfig(seq_parallel=args.seq_parallel))
    mesh = None
    if distributed:
        from mst_torch.parallel import create_mesh, replicate, shard_batch
        mesh = create_mesh(config.mesh.data_parallel,
                           config.mesh.seq_parallel, device=args.device)
        device = mesh.device
        if args.batch_size % mesh.shape["data"] != 0:
            raise SystemExit(
                f"--batch-size must be divisible by the data axis "
                f"({mesh.shape['data']} ranks): each rank owns whole batch "
                f"rows (of every step of a --steps-per-dispatch stack)")
    else:
        device = resolve_device(None if args.device == "cuda"
                                else args.device)
    lead = mesh is None or dist.get_rank() == 0   # logs and saves
    say = print if lead else (lambda *a, **k: None)
    tr.reproducible_backends()
    if args.compute_dtype or args.storage_dtype:
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model,
            compute_dtype=args.compute_dtype or config.model.compute_dtype,
            storage_dtype=args.storage_dtype or config.model.storage_dtype))
    t = config.train
    say(f"Using {device}" + (f": {torch.cuda.get_device_name(device)}"
                             if device.type == "cuda" else ""))
    if mesh is not None:
        say(f"Process mesh: {mesh.shape} ({dist.get_backend()})")
    capture = not args.no_capture
    if capture and mesh is not None:
        capture = False
        say("Capture off: a step over a process mesh is not captured "
            "(gloo, which ranks that share a card use, cannot be recorded "
            "in a CUDA graph, and the capture of NCCL collectives is not "
            "ported)")
    if capture and args.profile_dir:
        capture = False
        say("Capture off: --profile-dir traces the eager step (a replayed "
            "graph carries no record_function scope)")
    if device.type == "cuda":
        say("Steps: " + ("captured as CUDA graphs" if capture else "eager"))
    say("Listing data files")
    files = sorted(glob.glob(os.path.join(args.data, "**/*.mid"),
                             recursive=True))
    if not files:
        raise SystemExit(f"no .mid files under {args.data}")
    say(f"{len(files)} files")

    say("Creating model")
    state = tr.create_train_state(config, device=device)
    checkpoints = CheckpointManager(args.snapshots)
    start_iteration = 0
    resume_cursor = 0
    if args.resume:
        latest = checkpoints.latest_step()
        if latest is not None:
            start_iteration = latest + 1
            resume_cursor = checkpoints.load_cursor(latest) or 0
            checkpoints.restore(state, latest)
            say(f"Resuming from snapshot {latest} "
                f"(data cursor {resume_cursor})")
    if mesh is not None:
        replicate(state, mesh)      # every rank starts from rank 0's state

    say("Training")
    logger = CsvLogger(args.csv) if lead else None
    pbar = ProgressBar(t.n_iterations - start_iteration) if lead else None
    cache = None
    if args.cache_mb > 0:
        from mst_torch.data.cache import SongCache
        cache = SongCache(max_bytes=args.cache_mb << 20)
    songs = iter_inputs(files, shuffle=True, looped=True,
                        min_n_messages=t.min_n_messages,
                        rng=np.random.default_rng(t.seed),
                        start_at=resume_cursor, cache=cache)

    def group_stream():
        """Yield (data_cursor, (songs, Cb, Rb, caps)): one bucketed group of
        ``batch_size`` songs per training step, shapes decided but device
        tensors not yet built."""
        while True:
            if args.batch_size == 1:
                _, song = next(songs)
                if song.pitched_empty:
                    continue
                max_n_bars = t.max_total_bars // song.n_channels
                Cb = tr.bucket_shape(song.n_channels, t.channel_buckets)
                Rb = tr.bucket_shape(min(song.n_bars, max_n_bars),
                                     t.bar_buckets)
                yield song.cursor, ([song], Cb, Rb, [min(max_n_bars, Rb)])
                continue
            group, caps = [], []
            while len(group) < args.batch_size:
                _, song = next(songs)
                if song.pitched_empty:
                    continue
                if group and song.beats_per_bar != group[0].beats_per_bar:
                    continue  # batch tensors share one beats-per-bar axis
                group.append(song)
                caps.append(t.max_total_bars // song.n_channels)
            Cb = tr.bucket_shape(max(s.n_channels for s in group),
                                 t.channel_buckets)
            Rb = tr.bucket_shape(max(min(s.n_bars, c)
                                     for s, c in zip(group, caps)),
                                 t.bar_buckets)
            # memory budget: cap the bar bucket so B*Cb*Rb*T activations
            # fit; truncation beyond the cap mirrors max_total_bars
            Rb = tr.clamp_bar_bucket(Rb, len(group), Cb,
                                     group[0].beats_per_bar,
                                     t.batch_cell_budget, t.bar_buckets)
            caps = [min(c, Rb) for c in caps]
            yield group[-1].cursor, (group, Cb, Rb, caps)

    def stack_signature(g):
        songs_g, Cb, Rb, _ = g
        has_u = any(s.has_unpitched for s in songs_g)
        return (len(songs_g), Cb, Rb, songs_g[0].beats_per_bar, has_u)

    spd = args.steps_per_dispatch
    if spd > 1:
        groups = group_stream()
        if args.bucket_window:
            groups = tr.window_sort(groups, args.bucket_window,
                                    stack_signature)
        stacks = tr.group_stacks(groups, spd, stack_signature,
                                 limit=t.n_iterations - start_iteration)
    else:
        stacks = ((c, [g]) for c, g in group_stream())

    def build_stream():
        """Build batches on the prefetch thread: one raster build covers
        the whole stack (K*B songs), so host parsing and the record upload
        of the next stack overlap the current steps."""
        for cursor, groups in stacks:
            if mesh is not None and len(groups) > 1:
                # b-major stack: a rank's rows are whole b blocks
                # (make_multi_train_step with a mesh)
                B = len(groups[0][0])
                songs_flat = [g[0][b] for b in range(B) for g in groups]
                caps = [g[3][b] for b in range(B) for g in groups]
            else:
                songs_flat = [s for g in groups for s in g[0]]
                caps = [c for g in groups for c in g[3]]
            _, Cb, Rb, _ = groups[0]
            if args.exact_shapes:
                if args.batch_size == 1:
                    batch = tr.batch_from_song(
                        songs_flat[0],
                        t.max_total_bars // songs_flat[0].n_channels,
                        device=device)
                    if batch is None:
                        continue
                else:
                    batch = tr.pad_batch(songs_flat, Cb, Rb, bar_cap=caps,
                                         device=device)
                if mesh is not None:
                    batch = shard_batch(batch, mesh)
            else:
                # K1 writes the rasters at the storage dtype; over ranks,
                # each rank's rows and bars alone. This thread launches K1
                # on the card's default stream, the stream the main thread
                # copies the batch into a captured step's inputs on, so the
                # copy runs after K1
                batch = tr.device_batch_from_songs(
                    songs_flat, Cb, Rb, bar_cap=caps, device=device,
                    raster_dtype=config.model.storage_dtype, mesh=mesh)
            yield cursor, (len(groups), batch)

    batches = prefetch_iterator(build_stream(), depth=t.prefetch_depth)
    step_fns = {}

    def record(base_iteration, loss_vecs, has_unpitched):
        # one host fetch for the whole call: (n,) for a single step or
        # (K, n) for a stack; every rank holds the same global losses and
        # checks them, so a NaN stops every rank, not rank 0 alone while
        # the others wait in the next step's collectives
        arr = loss_vecs.cpu().numpy()
        for j, row in enumerate(arr.reshape(-1, arr.shape[-1])):
            losses = LossDict(*[float(v) for v in row])
            values = dict(
                total_loss=losses.total,
                pitched_loss=losses.pitched_total,
                pitched_notes_loss=losses.pitched_notes,
                song_info_loss=losses.song_info_total,
                instruments_loss=losses.instruments,
                channels_loss=losses.channels_total,
                mode_loss=losses.mode,
                bpm_loss=losses.bpm,
            )
            if has_unpitched:
                values.update(unpitched_loss=losses.unpitched_total,
                              unpitched_notes_loss=losses.unpitched_notes)
            # parity: train-model.py:125, widened to every component — a
            # NaN in one branch must never hide behind a zeroed mean
            assert all(np.isfinite(v) for v in values.values()), values
            if not lead:
                continue
            pbar.add(1, **values)
            logger.append(iteration=base_iteration + j,
                          **flatten_losses(losses))

    data_cursor = resume_cursor
    pending = None  # (first iteration, device loss vector(s), has_u)
    profile = None
    iteration = start_iteration
    while iteration < t.n_iterations:
        data_cursor, (ksteps, batch) = next(batches)
        has_unpitched = batch.unpitched is not None
        key = (has_unpitched, ksteps)
        if key not in step_fns:
            # one step function per kind; a captured one holds a graph per
            # shape key (the batch's shapes, dtypes and apply pattern) in
            # state.programs
            step_fns[key] = (
                tr.make_train_step(config, has_unpitched, mesh=mesh,
                                   capture=capture)
                if ksteps == 1 else
                tr.make_multi_train_step(config, has_unpitched, ksteps,
                                         mesh=mesh, capture=capture))
        if (args.profile_dir and lead and profile is None
                and iteration >= 10):
            # this dispatch warms the tracer up; the next 5 iterations are
            # traced
            profile = contextlib.ExitStack()
            end_warmup = profile.enter_context(
                profiler_trace(args.profile_dir))
            profile.enter_context(model_scopes(state.model))
            traced_from = iteration + ksteps
        state, loss_vec = step_fns[key](state, batch)
        if profile is not None:
            if iteration + ksteps == traced_from:
                end_warmup()
            elif iteration + ksteps >= traced_from + 5:
                profile.close()
                print(f"profile written to {args.profile_dir}")
                args.profile_dir, profile = None, None

        # fetch the PREVIOUS call's losses: the copy then waits only for
        # work already queued, not for this step
        if pending is not None:
            record(*pending)
        pending = (iteration, loss_vec, has_unpitched)

        crossed_save = (iteration // t.save_interval) != \
            ((iteration + ksteps - 1) // t.save_interval) or \
            iteration % t.save_interval == 0
        iteration += ksteps
        if crossed_save:
            # drain the deferred fetch first: record() asserts every loss
            # component is finite, so a NaN-poisoned state is never saved
            record(*pending)
            pending = None
            if lead:
                checkpoints.save(iteration - 1, state, cursor=data_cursor)

    if pending is not None:
        record(*pending)
    if profile is not None:
        profile.close()
    if pbar is not None:
        pbar.close()
    return state


if __name__ == "__main__":
    main()
