#!/usr/bin/env python
"""Device time of the serving programs' compaction on the card, at the
12-job smoke request's shape:

    python tools/compaction_torch.py [--iters 20]

Packed words of 12 jobs at Cb 8, Rb 128, T 4 (2,293,760 pitched and
240,640 unpitched cells a job) are drawn from a seed: about 500 to 1,300
notes a job and one job of about 10,000, the 2 or 3 channels and 69 to 124
bars of the smoke songs. CUDA events time, per call (after 3 warm-up
calls), ``transfer._compact_song`` at the 16,384 and 65,536 tiers (the
pitched words, then the unpitched at a quarter of the capacity),
``_compact_song_dense`` at 65,536, ``_pack_pool`` of the 65,536-tier
records at 32,768, and ``_pack_word`` of a (12, 8, 128, 4, 10, 56, 5)
applier output; beside them two yardsticks that the port does not run:
``cumsum`` along the 128-cell blocks (what the block prefix product
replaces) and ``torch.nonzero`` of the masked words (the port's earlier
compaction, which waits for the device). The block-routed records must
equal the dense compaction's. Then K6 (``compact_kernel.pack_compact``)
beside the composition it replaces, ``_compact_song`` of ``_pack_word``,
on applier outputs whose velocities clear the 0.01 gate at the notes
alone (the same densities; (12, 1, 128, 4, 10, 47, 2) for the unpitched
family), at the 16,384 and 65,536 tiers: the outputs must be bit-equal.
It prints the card's name and power limit. Without a card it raises.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CHANNELS = (3, 2, 2, 3, 2, 3, 2, 2, 3, 2, 3, 2)
N_BARS = (124, 69, 100, 124, 90, 110, 69, 100, 124, 90, 110, 69)


def cuda_ms(fn, iters):
    """Mean device ms of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def words(shape, density, seed):
    """int64 words of the given per-job note ``density`` ((B,)), on the
    card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    on = torch.rand(shape, generator=g) < density.view(
        (-1,) + (1,) * (len(shape) - 1))
    return torch.where(on, torch.randint(1, 2 ** 31, shape, generator=g),
                       0).cuda()


def applier_output(shape, density, seed):
    """An fp32 applier output on the card whose velocities clear the 0.01
    gate at the per-job ``density`` ((B,)) of the cells alone."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=g)
    x[..., 0] *= 6.0
    on = torch.rand(shape[:-1], generator=g) < density.view(
        (-1,) + (1,) * (len(shape) - 2))
    x[..., 1] = torch.where(on, x[..., 1], x[..., 1] * 0.0099)
    return x.cuda()


def composition(x, tpb, n_channels, n_bars, capacity, max_blocks):
    """What K6 replaces: ``_compact_song`` of ``_pack_word``."""
    from mst_torch import transfer as tr
    word = tr._pack_word(x, tpb.view(-1, 1, 1, 1, 1, 1))
    return tr._compact_song(word, n_channels, n_bars, capacity, max_blocks)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    import torch

    from mst_torch import transfer as tr
    from mst_torch.ops import compact_kernel

    if not torch.cuda.is_available():
        raise RuntimeError("compaction_torch: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    B, C, R, T = 12, 8, 128, 4
    density = torch.full((B,), 0.0015)
    density[3] = 0.012
    word_p = words((B, C, R, T, 10, 56), density, 0)
    word_u = words((B, 1, R, T, 10, 47), torch.full((B,), 0.003), 1)
    n_ch = torch.tensor(N_CHANNELS).cuda()
    n_bars = torch.tensor(N_BARS).cuda()
    u_ch = torch.ones_like(n_ch)
    ms = {}
    for cap in (16384, 65536):
        blocks_p, blocks_u = tr._block_capacities(cap)
        ms[f"_compact_song pitched, {cap}"] = cuda_ms(
            lambda: tr._compact_song(word_p, n_ch, n_bars, cap, blocks_p),
            args.iters)
        ms[f"_compact_song unpitched, {cap // 4}"] = cuda_ms(
            lambda: tr._compact_song(word_u, u_ch, n_bars, cap // 4,
                                     blocks_u), args.iters)
    count, _, rec = tr._compact_song(word_p, n_ch, n_bars, 65536,
                                     tr._block_capacities(65536)[0])
    dense_count, _, dense_rec = tr._compact_song_dense(word_p, n_ch, n_bars,
                                                       65536)
    n = int(count.max())
    if not (torch.equal(count, dense_count) and torch.equal(
            rec[:, :n], dense_rec[:, :n])):
        raise AssertionError("block-routed and dense records differ")
    ms["_compact_song_dense pitched, 65536"] = cuda_ms(
        lambda: tr._compact_song_dense(word_p, n_ch, n_bars, 65536),
        args.iters)
    ms["_pack_pool, 32768 of the 65536-tier records"] = cuda_ms(
        lambda: tr._pack_pool(rec, count, 32768), args.iters)
    x = applier_output((B, C, R, T, 10, 56, 5), density, 2)
    tpb = torch.full((B,), 480.0, device="cuda")
    ms["_pack_word"] = cuda_ms(
        lambda: tr._pack_word(x, tpb.view(B, 1, 1, 1, 1, 1)), args.iters)
    mask = (word_p != 0).to(torch.uint8).view(B, -1, 128)
    ms["yardstick: cumsum along the blocks"] = cuda_ms(
        lambda: mask.cumsum(-1, dtype=torch.uint8), args.iters)
    flat = tr._masked_flat(word_p, n_ch, n_bars)
    ms["yardstick: torch.nonzero (waits for the device)"] = cuda_ms(
        lambda: torch.nonzero(flat), args.iters)
    x_u = applier_output((B, 1, R, T, 10, 47, 2), torch.full((B,), 0.003), 3)
    for cap in (16384, 65536):
        blocks_p, blocks_u = tr._block_capacities(cap)
        for family, xf, ch, c, blocks in (
                ("pitched", x, n_ch, cap, blocks_p),
                ("unpitched", x_u, u_ch, cap // 4, blocks_u)):
            inputs = (xf, tpb, ch, n_bars, c, blocks)
            with torch.inference_mode():
                got = compact_kernel.pack_compact(*inputs)
                want = composition(*inputs)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K6 and the composition differ: "
                                     f"{family}, {c}")
            ms[f"K6 pack_compact {family}, {c}"] = cuda_ms(
                lambda: compact_kernel.pack_compact(*inputs), args.iters)
            ms[f"_compact_song(_pack_word) {family}, {c}"] = cuda_ms(
                lambda: composition(*inputs), args.iters)
    print(f"{smi}; notes a job {count.tolist()}")
    for name, t in ms.items():
        print(f"  {name}: {t:.4f} ms")
    return ms


if __name__ == "__main__":
    main()
