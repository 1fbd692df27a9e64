"""With the program broken underneath, a run's ``correct`` comes out
false: the harness runs on the CPU at a small size (the kernels' plain
versions), with the look for a card skipped."""

import time

import pytest
import torch

from benchmark import harness

from .conftest import tiny_train_cell


def _run(cell, breaker=None, seed=2 ** 31 + 7):
    return harness.execute(cell, seed, 0.2, False, time.perf_counter(),
                           device="cpu", breaker=breaker)


def test_sound_runs_are_correct(tiny_serve):
    line = _run(tiny_serve)
    assert line["correct"], line["checks"]


def test_an_altered_answer_fails(tiny_serve, monkeypatch):
    """Every produced note's velocity byte moved up by 3 where the apply
    packs it."""
    import mst_torch.transfer as transfer
    pack = transfer._pack_word

    def altered(x, tpb):
        word = pack(x, tpb)
        room = (127 - ((word >> 8) & 0xFF)).clamp(max=3)
        return torch.where(word != 0, word + (room << 8), word)

    monkeypatch.setattr(transfer, "_pack_word", altered)
    line = _run(tiny_serve)
    assert not line["correct"]
    assert line["checks"]["note_gap"]["value"] > \
        line["checks"]["note_gap"]["limit"]


@pytest.mark.parametrize("name,batch", [("train.fp32.b1", 1),
                                        ("train.bf16.b6", 2)])
def test_a_state_left_unchanged_fails(name, batch):
    cell = tiny_train_cell(name, batch)

    def frozen(state):
        state.optimizer.step = lambda *a, **k: None

    line = _run(cell, frozen)
    assert not line["correct"]
    assert line["checks"]["delta_gap"]["value"] > 0.9


def test_half_the_batch_left_out_fails(monkeypatch):
    import mst_torch.runtime.train as tr
    loss_fn = tr.loss_fn

    def half(model, batch, *args, **kwargs):
        n = batch.mode.shape[0] // 2
        batch = tr.Batch(*(None if f is None else f[:n] for f in batch))
        return loss_fn(model, batch, *args, **kwargs)

    monkeypatch.setattr(tr, "loss_fn", half)
    line = _run(tiny_train_cell("train.bf16.b6", 2))
    assert not line["correct"]


@pytest.mark.parametrize("name,batch", [("train.fp32.b1", 1),
                                        ("train.bf16.b6", 2)])
def test_sound_training_runs_are_correct(name, batch):
    line = _run(tiny_train_cell(name, batch))
    assert line["correct"], line["checks"]
