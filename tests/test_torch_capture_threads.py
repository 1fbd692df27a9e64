"""Captured programs (mst_torch.runtime.programs) beside another thread
that works on the card, as the trainer's prefetch thread does while the
main thread captures a training step.

On the card only (the ``card`` fixture skips without one; this file
imports no JAX, so it runs there with ``python3 -m pytest --noconftest
tests/test_torch_capture_threads.py``): a thread builds batch after batch
with ``device_batch_from_songs`` (K1 launches, pageable copies that
synchronise its stream) while the main thread captures the batch-1
micro-step's two programs (with and without the apply) on fresh states;
every capture must succeed. In torch's default ``"global"`` capture mode
the other thread's calls invalidated such a capture on the card.
"""

import os
import threading

import pytest
import torch

from mst_torch.config import Config
from mst_torch.device import strict_fp32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURES = 8      # fresh states, two programs each


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    strict_fp32()
    return torch.device("cuda")


@pytest.mark.card
def test_captures_beside_a_thread_that_builds_batches(card):
    from mst_torch.runtime import train as tr
    from mst_torch.transfer import get_model_input

    song = get_model_input(os.path.join(ROOT, "mst_torch", "assets",
                                        "smoke", "comp_0.mid"))[1]
    config = Config()
    t = config.train
    cap = t.max_total_bars // song.n_channels
    rb = tr.bucket_shape(min(song.n_bars, cap), t.bar_buckets)
    cb = tr.bucket_shape(song.n_channels, t.channel_buckets)

    def batch():
        return tr.device_batch_from_songs([song], cb, rb,
                                          bar_cap=[min(cap, rb)],
                                          device="cuda")

    first = batch()
    has_u = first.unpitched is not None
    stop, errors, built = threading.Event(), [], [0]

    def build():
        try:
            while not stop.is_set():
                batch()
                built[0] += 1
        except BaseException as exc:       # reported by the main thread
            errors.append(exc)

    worker = threading.Thread(target=build, daemon=True)
    worker.start()
    try:
        for _ in range(CAPTURES):
            state = tr.create_train_state(config, device="cuda", seed=108)
            step = tr.make_train_step(config, has_u, capture=True)
            for _ in range(t.iter_size):
                step(state, first)
            assert len(state.programs.graphs) == t.iter_size
    finally:
        stop.set()
        worker.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert built[0] > 0
