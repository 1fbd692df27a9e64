"""Tests of the benchmark's harness. Those marked ``card`` need an NVIDIA
GPU; the ``card`` fixture skips them elsewhere (the check is made when the
test runs, never when a module is imported)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def tiny_serve():
    """The serve cell at a size the CPU holds: one composition and one
    style of 20-24 bars, two requests' worth of pool."""
    from benchmark import harness
    cell = harness.Cell("serve.fp32.r3x3")
    cell.mix = dict(cell.mix, compositions=1, styles=1, pool=2,
                    sizes=[[4, 20, 2, 1], [4, 24, 3, 1]], key=[64, 512, 2048],
                    requests=2, warmup_cycles=[1, 1], sample=1)
    return cell


def tiny_train_cell(name, batch):
    from benchmark import harness
    cell = harness.Cell(name)
    cell.mix = dict(cell.mix, corpus=6,
                    sizes=[[4, 8 + i, 2 + i % 2, 1] for i in range(6)],
                    compare_applies=2, warmup=[1, 2, 1], batch=batch)
    return cell
