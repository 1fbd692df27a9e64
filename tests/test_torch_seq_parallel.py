"""The port's sequence-parallel LSTM recurrence (mst_torch.parallel.seq_lstm)
against the dense scan and against mst_tpu's, on the CPU.

Four gloo ranks (tests/torch_ranks.py) run every case of
``torch_ranks.SEQ_CASES`` once: the relay at n = 2 and 4 (and B = 1), the
row-microbatched pipeline at (n, B) = (2, 16), (4, 16) and (4, 9), both
directions, the activity witness and the bf16-compute case of
tests/test_precision.py:153 (mirrors of tests/test_seq_parallel.py:11-118).
Tolerances:

- each rank's outputs, its gates' gradient and the w_hh gradient against
  the port's dense ``_recur`` on the whole sequence: bit-equal (on this
  CPU a matmul gives the same bits for B/n rows as for B at these shapes,
  and the w_hh gradient adds the steps' terms in the dense order);
- the assembled ``seq_sharded_lstm`` against mst_tpu's on the 8 virtual
  CPU devices: rtol 1e-5, atol 1e-6 in fp32 (two frameworks' sums in other
  orders, tests/test_seq_parallel.py's own tolerance), and
  tests/test_torch_precision.py's rtol 1e-2, atol 1e-3 under bf16 compute
  (a sum on the other side of a bf16 rounding moves by 2**-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import precision as jprecision
from mst_tpu.parallel import create_mesh as j_create_mesh
from mst_tpu.parallel import seq_lstm as j_seq_lstm
from mst_torch.ops import precision
from mst_torch.ops.lstm import _recur
from tests.torch_ranks import SEQ_CASES, run_ranks, seq_inputs

JAX_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=1e-2, atol=1e-3)}
CASES = {case["name"]: case for case in SEQ_CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("seq", 4, tmp_path_factory.mktemp("seq"))


def _assembled(ranks, name, key):
    """The chunks of one seq axis (data index 0), in bar order."""
    recs = sorted((r[name] for r in ranks if r[name]["data_index"] == 0),
                  key=lambda rec: rec["seq_index"])
    return torch.cat([rec[key] for rec in recs], dim=1)


def _dense(case):
    """The port's dense scan of the whole sequence (flipped for reverse):
    outputs, and the gradients of the gates and of w_hh."""
    x, w_ih, w_hh, b, ct = (torch.from_numpy(a) for a in seq_inputs(case))
    with precision.precision(case["compute"]):
        gates = (precision.matmul(x, w_ih) + b).detach().requires_grad_()
        w = w_hh.clone().requires_grad_()
        src = gates.flip(1) if case["reverse"] else gates
        out = _recur(src[None], w[None])[0]
        out = out.flip(1) if case["reverse"] else out
        (out * ct).sum().backward()
    return out.detach(), gates.grad, w.grad


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_seq_scan_bit_equal_to_dense_scan(ranks, name):
    """Forward and gradients of every schedule equal the dense scan's bits;
    every rank gets the whole w_hh gradient."""
    case = CASES[name]
    want_out, want_gates, want_w = _dense(case)
    got = _assembled(ranks, name, "out")
    assert torch.equal(_bits(got), _bits(want_out))
    assert torch.equal(_assembled(ranks, name, "d_gates"), want_gates)
    for r in ranks:
        assert torch.equal(_bits(r[name]["d_w_hh"]), _bits(want_w))


@pytest.mark.parametrize("name", list(CASES))
def test_seq_sharded_lstm_tracks_mst_tpu(ranks, name):
    """The assembled ``seq_sharded_lstm`` (projection + staged scan) against
    mst_tpu's on the 8 virtual CPU devices, under the case's policy."""
    case = CASES[name]
    x, w_ih, w_hh, b, _ = (jnp.asarray(a) for a in seq_inputs(case))
    mesh = j_create_mesh(n_data=8 // case["n"], n_seq=case["n"])
    with jprecision.precision(case["compute"]):
        want = jax.jit(lambda *a: j_seq_lstm.seq_sharded_lstm(
            *a, mesh, reverse=case["reverse"]))(x, w_ih, w_hh, b)
    got = _assembled(ranks, name, "lstm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **JAX_TOL[case["compute"]])


def test_pipeline_concurrency_witness(ranks):
    """The pipeline's (n, 2n-1) activity matrix: rank s scans one
    microbatch at each of stages s..s+n-1, so at stage n-1 every rank
    scans at once; every rank holds the same matrix, mst_tpu's."""
    case = CASES["witness-n4"]
    n, b_mb = case["n"], case["B"] // case["n"]
    activity = ranks[0]["witness-n4"]["activity"].numpy()
    expect = np.zeros((n, 2 * n - 1), np.int32)
    for s in range(n):
        expect[s, s:s + n] = b_mb
    np.testing.assert_array_equal(activity, expect)
    assert (activity[:, n - 1] == b_mb).all()
    assert activity.sum() == case["B"] * n
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["witness-n4"]["activity"].numpy(),
                                      activity)
    four_h = 4 * case["H"]
    mesh = j_create_mesh(n_data=8 // n, n_seq=n)
    _, j_activity = jax.jit(lambda g, w: j_seq_lstm.seq_sharded_scan_pipelined(
        g, w, mesh, with_activity=True))(
            jnp.zeros((case["B"], case["T"], four_h)),
            jnp.zeros((case["H"], four_h)))
    np.testing.assert_array_equal(activity, np.asarray(j_activity))
