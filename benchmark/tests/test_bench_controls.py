"""The control of each cell, on the card: the plain reference one
precision step below the configuration's, put in the program's place,
must fail one of the cell's numbers on three seeds (and, for batches of
more than one song, so must the reference with half of each batch left
out). ``benchmark/tests/controls.py`` reads the same numbers at the
cells' own sizes for PERF.md."""

import pytest

from benchmark import harness
from benchmark.tests import controls

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _fails(reading, limits):
    return any(reading[k] > limits[k] for k in reading if k in limits)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_control_fails(card, seed):
    cell = harness.Cell("serve.fp32.r3x3")
    reading = controls.serve_control(cell, seed)     # as many as a run
    assert _fails(reading, cell.workload["check"]), reading


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["train.fp32.b1", "train.bf16.b6"])
def test_train_control_fails(card, name, seed):
    cell = harness.Cell(name)
    readings = controls.train_control(cell, seed)
    for kind, reading in readings.items():
        assert _fails(reading, cell.workload["check"]), (kind, reading)
