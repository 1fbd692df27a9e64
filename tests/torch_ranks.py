"""Rank processes for the port's multi-process tests (no JAX here).

``run_ranks(job, world, tmp_path)`` (or ``start_ranks`` and, after other
work, ``join_ranks``) starts ``world`` processes of this file; each joins a gloo group through a ``FileStore`` in ``tmp_path`` (no
TCP port, so parallel test workers cannot collide), runs ``JOBS[job]``
with one CPU thread and saves what it returns to ``tmp_path``. The group
has a timeout and so has the join: a deadlocked collective fails the test
instead of hanging the suite.

The jobs read their inputs from ``tmp_path``: ``inputs.json`` (widths,
song files, bucket shapes) and ``weights.pt`` (a state dict), written by
the test from mst_tpu's side.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 120     # seconds a collective may wait
JOIN_TIMEOUT = 420      # seconds the ranks may take together


def start_ranks(job, world, tmp_path):
    """Start ``job`` on ``world`` gloo ranks; ``join_ranks`` collects
    them. The caller may work meanwhile."""
    tmp = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp, f"{job}-rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(rank),
             str(world), tmp], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    return dict(job=job, tmp=tmp, procs=procs, logs=logs,
                started=time.monotonic())


def join_ranks(started, timeout=JOIN_TIMEOUT):
    """Wait for the ranks of ``start_ranks`` (``timeout`` seconds from
    their start); returns each rank's result."""
    import torch
    job, procs, logs = started["job"], started["procs"], started["logs"]
    deadline = started["started"] + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{job}: ranks still running after "
                             f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-3000:])
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"{job} rank {rank}:\n{tails[rank]}"
    return [torch.load(os.path.join(started["tmp"], f"{job}-rank{r}.pt"))
            for r in range(len(procs))]


def run_ranks(job, world, tmp_path, timeout=JOIN_TIMEOUT):
    """Run ``job`` on ``world`` gloo ranks; returns each rank's result."""
    return join_ranks(start_ranks(job, world, tmp_path), timeout)


def _inputs(tmp):
    with open(os.path.join(tmp, "inputs.json")) as fh:
        return json.load(fh)


def _songs(paths):
    from mst_torch.data.pipeline import get_input
    from mst_torch.io import smf
    from mst_torch.ops.events import read_midi
    songs = []
    for path in paths:
        with open(path, "rb") as fh:
            songs.append(get_input(*read_midi(smf.parse_midi_bytes(
                fh.read()))))
    return songs


def job_allreduce(rank, world, tmp):
    """A sum across the processes and the default corpus partition."""
    import torch
    import torch.distributed as dist

    from mst_torch.parallel import shard_files_for_host
    x = torch.tensor([float(rank), 100.0 + rank])
    dist.all_reduce(x)
    files = [f"song{i}.mid" for i in range(7)]
    return {"sum": x.tolist(), "shard": shard_files_for_host(files)}


def job_data_parallel(rank, world, tmp):
    """One data-parallel micro-step, its accumulated gradients, the
    per-rank losses taken alone, then a second micro-step that applies,
    on the global batch of ``inputs.json`` over a data axis of ``world``
    ranks and of 2 (the (2, world/2) mesh, whose seq ranks hold their
    rows' bars in halves or quarters); with 2 ranks also a stacked
    two-step call against two single steps."""
    import dataclasses

    import torch

    from mst_torch.config import Config, ModelConfig
    from mst_torch.models import StyleTransferModel
    from mst_torch.parallel import (create_mesh, make_sharded_train_step,
                                    replicate)
    from mst_torch.runtime import train as tr

    spec = _inputs(tmp)
    config = Config(model=ModelConfig(**spec["widths"]))
    weights = torch.load(os.path.join(tmp, "weights.pt"))
    songs = _songs(spec["songs"])
    out = {}
    for n_data in (world, 2):
        mesh = create_mesh(n_data=n_data, n_seq=world // n_data,
                           device="cpu")
        model = StyleTransferModel(config.model)
        model.load_state_dict(weights)
        # parameters other than the data axis's first rank's: replicate
        # must overwrite them
        if mesh.data_index:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        state = replicate(tr.create_train_state(config, device="cpu",
                                                model=model), mesh)

        def batch_of(group, caps, of=mesh):
            return tr.device_batch_from_songs(
                group, spec["Cb"], spec["Rb"], bar_cap=caps, device="cpu",
                mesh=of)
        batch = batch_of(songs, spec["caps"])
        has_u = batch.unpitched is not None
        # the loss of this rank's rows alone, every bar of them
        rows = dataclasses.replace(mesh, shape=dict(mesh.shape, seq=1),
                                   seq_index=0)
        with torch.no_grad():
            alone = tr.loss_fn(state.model, batch_of(
                songs, spec["caps"], rows), has_u).total.item()
        step = make_sharded_train_step(config, has_u, mesh)
        _, vec1 = step(state, batch)
        grads = {n: p.grad.clone() for n, p in
                 state.model.named_parameters() if p.grad is not None}
        _, vec2 = step(state, batch)
        rec = dict(data_index=mesh.data_index, seq_index=mesh.seq_index,
                   losses=[vec1, vec2], grads=grads, alone=alone,
                   batch=batch._asdict(), opt_step=state.opt_step,
                   params={n: p.detach().clone() for n, p in
                           state.model.named_parameters()})
        if n_data == 2:
            # the stack of two groups, b-major: (songs, songs reversed)
            second = songs[::-1]
            flat = [g[b] for b in range(len(songs)) for g in (songs,
                                                              second)]
            caps = [g[b] for b in range(len(songs)) for g in
                    (spec["caps"], spec["caps"][::-1])]
            stack = tr.device_batch_from_songs(
                flat, spec["Cb"], spec["Rb"], bar_cap=caps, device="cpu",
                mesh=mesh)
            model = StyleTransferModel(config.model)
            model.load_state_dict(weights)
            multi = tr.make_multi_train_step(config, has_u, 2, mesh=mesh,
                                             capture=False)
            _, rec["stacked"] = multi(tr.create_train_state(
                config, device="cpu", model=model), stack)
            model = StyleTransferModel(config.model)
            model.load_state_dict(weights)
            state = tr.create_train_state(config, device="cpu", model=model)
            rec["single"] = [step(state, batch_of(g, c))[1] for g, c in
                             ((songs, spec["caps"]),
                              (second, spec["caps"][::-1]))]
        out[n_data] = rec
    return out


def job_seq(rank, world, tmp):
    """Every case of ``SEQ_CASES`` on this rank's chunk."""
    import torch

    from mst_torch.ops import precision
    from mst_torch.parallel import create_mesh
    from mst_torch.parallel import seq_lstm

    meshes = {n: create_mesh(n_data=world // n, n_seq=n, device="cpu")
              for n in (2, 4)}
    out = {}
    for case in SEQ_CASES:
        mesh = meshes[case["n"]]
        x, w_ih, w_hh, b, ct = (torch.from_numpy(a)
                                for a in seq_inputs(case))
        t_l = x.shape[1] // case["n"]
        mine = slice(mesh.seq_index * t_l, (mesh.seq_index + 1) * t_l)
        with precision.precision(case["compute"]):
            gates = (precision.matmul(x, w_ih) + b)[:, mine].detach()
            gates.requires_grad_(True)
            w = w_hh.clone().requires_grad_(True)
            if case.get("pipelined"):
                got, activity = seq_lstm.seq_sharded_scan_pipelined(
                    gates, w, mesh, with_activity=True)
            else:
                got = seq_lstm.seq_sharded_scan(gates, w, mesh,
                                                reverse=case["reverse"])
                activity = None
            (got * ct[:, mine]).sum().backward()
            lstm = seq_lstm.seq_sharded_lstm(x[:, mine], w_ih, w_hh, b, mesh,
                                             reverse=case["reverse"])
        out[case["name"]] = dict(
            seq_index=mesh.seq_index, out=got.detach(), d_gates=gates.grad,
            d_w_hh=w.grad, lstm=lstm.detach(), activity=activity,
            data_index=mesh.data_index)
    return out


def _backward_on_fresh_thread(backward):
    """``Tensor.backward`` on a new thread, which starts without the
    caller's context variables, as the CUDA autograd engine's does."""
    import threading

    def run(self, *args, **kwargs):
        failed = []

        def target():
            try:
                backward(self, *args, **kwargs)
            except BaseException as e:      # re-raised on the caller
                failed.append(e)
        thread = threading.Thread(target=target)
        thread.start()
        thread.join()
        if failed:
            raise failed[0]
    return run


# the bar-sharded cases of job_seq_model: (name, n_data, n_seq, policy);
# the mutated ones break one guard each (tests/test_torch_seq_model.py)
SEQ_MODEL_CASES = [
    ("1x2", 1, 2, "float32"), ("1x4", 1, 4, "float32"),
    ("2x2", 2, 2, "float32"), ("1x2-bf16", 1, 2, "bfloat16"),
    ("1x2-local-bar-mask", 1, 2, "float32"),
    ("1x2-song-info-every-rank", 1, 2, "float32"),
]


def _mutate(case):
    """Undo one guard of the bar-sharded step for ``case`` (a context
    manager): the loss's bar mask by local index, or the song-info losses
    counted on every seq rank."""
    import contextlib

    import torch

    from mst_torch.ops import seq_context
    from mst_torch.runtime import train as tr
    stack = contextlib.ExitStack()

    def patch(module, name, value):
        old = getattr(module, name)
        setattr(module, name, value)
        stack.callback(setattr, module, name, old)
    if case.endswith("local-bar-mask"):
        patch(tr, "_bar_positions",
              lambda n, device: torch.arange(n, device=device))
    if case.endswith("song-info-every-rank"):
        patch(seq_context, "count_once", lambda *xs: xs)
    return stack


def job_seq_model(rank, world, tmp):
    """The bar-sharded train step on the global batch of ``inputs.json``
    for every case of SEQ_MODEL_CASES whose mesh holds this rank: the
    first micro-step's losses and accumulated gradients, and (fp32) the
    parameters after the second one applies; a remat step against the
    plain one over (2, 1) and (1, 2) with every backward on a fresh
    thread; and the cross-rank ops of mst_torch.ops.seq_context on
    (1, 2) and (1, 4) meshes."""
    import dataclasses

    import torch

    from mst_torch.config import Config, ModelConfig, TrainConfig
    from mst_torch.models import StyleTransferModel
    from mst_torch.parallel import create_mesh, replicate
    from mst_torch.runtime import train as tr

    spec = _inputs(tmp)
    weights = torch.load(os.path.join(tmp, "weights.pt"))
    songs = _songs(spec["songs"])
    meshes = {}

    def mesh_of(n_data, n_seq):
        # every rank forms every mesh's groups; a rank outside the grid
        # takes no part in its cases
        if (n_data, n_seq) not in meshes:
            try:
                meshes[n_data, n_seq] = create_mesh(n_data, n_seq,
                                                    device="cpu")
            except ValueError:
                meshes[n_data, n_seq] = None
        return meshes[n_data, n_seq]

    def run(config, mesh, steps):
        model = StyleTransferModel(config.model)
        model.load_state_dict(weights)
        state = replicate(tr.create_train_state(config, device="cpu",
                                                model=model), mesh)
        dtype = config.model.storage_dtype
        batch = tr.device_batch_from_songs(
            songs, spec["Cb"], spec["Rb"], bar_cap=spec["caps"],
            device="cpu", raster_dtype=dtype, mesh=mesh)
        step = tr.make_train_step(config, batch.unpitched is not None,
                                  mesh=mesh, capture=False)
        rec = {}
        for i in range(steps):
            _, vec = step(state, batch)
            if i == 0:
                rec["losses"] = vec
                rec["grads"] = {n: p.grad.clone() for n, p in
                                state.model.named_parameters()
                                if p.grad is not None}
        if steps > 1:
            rec["params"] = {n: p.detach().clone() for n, p in
                             state.model.named_parameters()}
            rec["opt_step"] = state.opt_step
        return rec

    out = {}
    for name, n_data, n_seq, policy in SEQ_MODEL_CASES:
        mesh = mesh_of(n_data, n_seq)
        if mesh is None:
            continue
        config = Config(model=ModelConfig(**spec["widths"],
                                          compute_dtype=policy,
                                          storage_dtype=policy))
        with _mutate(name):
            rec = run(config, mesh, 2 if policy == "float32" else 1)
        out[name] = dict(rec, data_index=mesh.data_index,
                         seq_index=mesh.seq_index)

    # remat over ranks, each backward() on a fresh thread
    plain_backward = torch.Tensor.backward
    torch.Tensor.backward = _backward_on_fresh_thread(plain_backward)
    try:
        for n_data, n_seq in ((2, 1), (1, 2)):
            mesh = mesh_of(n_data, n_seq)
            if mesh is None:
                continue
            config = Config(model=ModelConfig(**spec["widths"]))
            remat = dataclasses.replace(config, train=TrainConfig(
                remat=True))
            out[f"remat-{n_data}x{n_seq}"] = (run(config, mesh, 1),
                                             run(remat, mesh, 1))
    finally:
        torch.Tensor.backward = plain_backward
    out["ops"] = {n: _seq_ops(mesh_of(1, n)) for n in (2, 4)}
    return out


def _seq_ops(mesh):
    """masked_flip_bars and last_step on this rank's chunk of fixed
    inputs, values and gradients (the cotangent of the shared last step
    is seq rank 0's, zeros elsewhere), and last_step of a planted -0.0
    with the bits summed as int32 and, mutated, as floats."""
    if mesh is None:
        return None
    import torch

    from mst_torch.ops import seq_context
    from mst_torch.ops.seq_context import (last_step, masked_flip_bars,
                                           sequence_sharding)
    n, s = mesh.shape["seq"], mesh.seq_index
    x, lengths, ct_flip, ct_last = seq_op_inputs()
    t_l = x.shape[1] // n
    mine = slice(s * t_l, (s + 1) * t_l)
    out = {}
    with sequence_sharding(mesh):
        xl = x[:, mine].clone().requires_grad_()
        flipped = masked_flip_bars(xl, lengths)
        (flipped * ct_flip[:, mine]).sum().backward()
        out["flip"] = (flipped.detach(), xl.grad)
        for key, lens in (("last", lengths), ("last-none", None)):
            xl = x[:, mine].clone().requires_grad_()
            last = last_step(xl, lens)
            (last * (ct_last if s == 0 else 0.0)).sum().backward()
            out[key] = (last.detach(), xl.grad)
        planted = torch.zeros(2, t_l, 3)
        planted[:, -1] = -0.0           # the last bar of the last rank
        exact = last_step(planted)
        float_sum = seq_context.sum_bits
        seq_context.sum_bits = lambda buf, group: float_all_reduce(buf,
                                                                   group)
        try:
            mutated = last_step(planted)
        finally:
            seq_context.sum_bits = float_sum
        out["negative-zero"] = (exact, mutated)
    return out


def float_all_reduce(buf, group):
    import torch.distributed as dist
    dist.all_reduce(buf, group=group)
    return buf


def seq_op_inputs():
    """x (3, 16, 5), lengths spanning both halves and quarters, and the
    cotangents of the flip and of the last read."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 16, 5)).astype(np.float32))
    lengths = torch.tensor([16, 3, 9])
    ct_flip = torch.from_numpy(rng.normal(size=(3, 16, 5)).astype(
        np.float32))
    ct_last = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    return x, lengths, ct_flip, ct_last


def job_cli(rank, world, tmp):
    """train-model-torch.py's main in a rank whose group is formed. With
    ``nan`` in the inputs, every step's losses are made NaN after the real
    step ran, and what main raised is returned."""
    spec = importlib.util.spec_from_file_location(
        "train_model_torch", os.path.join(ROOT, "train-model-torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    inputs = _inputs(tmp)
    if not inputs.get("nan"):
        state = cli.main(inputs["argv"])
        return {"micro_step": state.micro_step, "opt_step": state.opt_step}
    from mst_torch.runtime import train as tr
    make_step = tr.make_train_step

    def poisoned(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch):
            state, vec = step(state, batch)
            return state, vec * float("nan")
        return run
    tr.make_train_step = poisoned
    try:
        cli.main(inputs["argv"])
    except AssertionError as exc:
        return {"raised": f"AssertionError: {exc}"}
    return {"raised": None}


# (n seq ranks, rows, bars, input width, hidden width): the mirrors of
# tests/test_seq_parallel.py and tests/test_precision.py:153
SEQ_CASES = [
    dict(name="relay-n2", n=2, B=2, T=64, D=16, H=24),
    dict(name="relay-n4", n=4, B=2, T=64, D=16, H=24),
    dict(name="relay-n4-B1", n=4, B=1, T=32, D=8, H=8),
    dict(name="pipeline-n2-B16", n=2, B=16, T=32, D=8, H=8),
    dict(name="pipeline-n4-B16", n=4, B=16, T=32, D=8, H=8),
    dict(name="pipeline-n4-B9", n=4, B=9, T=32, D=8, H=8),
    dict(name="reverse-relay-n4", n=4, B=2, T=32, D=8, H=8, reverse=True),
    dict(name="reverse-pipeline-n2", n=2, B=8, T=32, D=8, H=8,
         reverse=True),
    dict(name="witness-n4", n=4, B=8, T=16, D=8, H=8, pipelined=True),
    dict(name="bf16-n4", n=4, B=2, T=16, D=12, H=8, compute="bfloat16"),
    dict(name="bf16-pipeline-n2", n=2, B=8, T=16, D=12, H=8,
         compute="bfloat16"),
]
for _i, _case in enumerate(SEQ_CASES):
    _case.setdefault("reverse", False)
    _case.setdefault("compute", "float32")
    _case["seed"] = 100 + _i


def seq_inputs(case):
    """x (B, T, D), w_ih (D, 4H), w_hh (H, 4H), b (4H) and the output
    cotangent (B, T, H), float32 from the case's seed."""
    import numpy as np
    rng = np.random.default_rng(case["seed"])
    B, T, D, H = case["B"], case["T"], case["D"], case["H"]
    f = np.float32
    return (rng.normal(size=(B, T, D)).astype(f),
            (rng.normal(size=(D, 4 * H)) * 0.1).astype(f),
            (rng.normal(size=(H, 4 * H)) * 0.1).astype(f),
            (rng.normal(size=(4 * H,)) * 0.1).astype(f),
            rng.normal(size=(B, T, H)).astype(f))


JOBS = {"allreduce": job_allreduce, "data_parallel": job_data_parallel,
        "seq": job_seq, "cli": job_cli, "seq_model": job_seq_model}


def main():
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    from mst_torch.parallel import initialize_multihost
    torch.set_num_threads(1)
    initialize_multihost("file://" + os.path.join(tmp, "store"), world,
                         rank, backend="gloo", timeout=GROUP_TIMEOUT)
    try:
        result = JOBS[job](rank, world, tmp)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"{job}-rank{rank}.pt"))


if __name__ == "__main__":
    main()
