"""The port's kernel modules against the JAX package, on the CPU.

A CUDA kernel cannot run here; its wrapper takes the plain torch version for
CPU tensors, and chip_smoke.py holds each kernel to that plain version on
the card. These tests hold the plain versions to the JAX functions the
kernels replace:

- K1 (mst_torch.ops.raster_kernel): ``segment_rasterize_plain`` must be
  BIT-EQUAL to mst_tpu's ``segment_rasterize`` and to the Pallas kernel
  ``pallas_rasterize(..., interpret=True)`` — a max of the same fp32 values
  is exact whatever the order. On edge values (negatives, +-0.0, NaN of
  both signs, +-inf) it must be bit-equal, NaN positions equal, to
  ``segment_rasterize`` and to a numpy model of the int-bit rule that the
  CUDA kernel implements.
- K2 (mst_torch.ops.grid_kernel): ``grid_tail_plain`` must match
  ``_tail_unrolled`` (the serving path's tail) and ``fused_grid_tail(...,
  interpret=True)`` (the Pallas kernel) within atol = 1e-6: each output is a
  30-term fp32 sum that XLA's reduction may associate differently from the
  plain version's ascending-k loop, and the sigmoid's implementations differ
  in the last ulp. The tolerance applies to the sigmoid itself, before the
  per-feature output scale (6 for the duration feature, 1 for the others),
  so on the duration it is 6e-6.
- K3 (mst_torch.ops.grid_kernel): ``grid_tail_bwd_plain`` must match the
  Pallas backward kernel (``jax.vjp`` of ``fused_grid_tail(...,
  interpret=True)``) and autodiff of ``_tail_jnp`` within
  tests/test_fused_tails.py's tolerance, and autograd through ``GridTail``
  must match autograd of ``grid_tail_plain``.
- The bf16 forms (the bf16 storage policy): K1's bf16 raster must be the
  fp32 raster cast to bf16 and mst_tpu's ``segment_rasterize(out_dtype=
  bfloat16)`` and Pallas raster, bit for bit, and a numpy model of the
  kernel's 16-bit rule on edge values; the bf16 tail's plain forward and
  backward must track ``_tail_jnp`` and its gradients on bf16 inputs, in
  JAX's dtypes, within the tolerances stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import device_raster as jdr
from mst_tpu.ops.pallas_grid import _tail_unrolled, fused_grid_tail
from mst_tpu.ops.pallas_raster import pallas_rasterize
from mst_torch.ops import device_raster, grid_kernel, raster_kernel
from mst_torch.ops.precision import BF16

SCALE = (6.0, 1.0, 1.0, 1.0, 1.0)
K2_ATOL = 1e-6


def _records(rng, n, n_rows, n_notes, n_feat, *, sentinel_share=0.1,
             invalid_share=0.1, spill_rows=0):
    """Row-sorted note records with collisions (few rows, many notes),
    invalid notes, sentinel rows and rows past the raster."""
    row = rng.integers(0, n_rows + spill_rows, n).astype(np.int32)
    valid = rng.random(n) >= invalid_share
    row = np.where(rng.random(n) < sentinel_share, 2 ** 30, row)
    valid &= row < 2 ** 30
    dn = jdr.DeviceNotes(
        row=row, note_idx=rng.integers(0, n_notes, n).astype(np.int32),
        acc=(rng.integers(0, 3, n) if n_feat == 5
             else np.zeros(n)).astype(np.int32),
        duration=(rng.random(n) * 6).astype(np.float32),
        velocity=rng.random(n).astype(np.float32), valid=valid)
    order = np.argsort(dn.row, kind="stable")
    return jdr.DeviceNotes(*(a[order] for a in (
        dn.row, dn.note_idx, dn.acc, dn.duration, dn.velocity, dn.valid)))


def _torch_args(dn):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        dn.row, dn.note_idx, dn.acc, dn.duration, dn.velocity, dn.valid))


@pytest.mark.parametrize("n_notes,n_feat", [(56, 5), (47, 2)])
@pytest.mark.parametrize("n,n_rows", [(300, 40), (900, 1100), (0, 64)])
def test_raster_plain_bit_equal_to_jax_and_pallas(n, n_rows, n_notes,
                                                  n_feat):
    """Collisions (300 notes on 40 rows), a raster spanning several Pallas
    row chunks, and zero notes; sentinel rows, invalid notes and valid rows
    past n_rows are skipped by all three."""
    rng = np.random.default_rng(n + n_rows + n_feat)
    dn = _records(rng, n, n_rows, n_notes, n_feat, spill_rows=n_rows // 8)
    want_jnp = np.asarray(jdr.segment_rasterize(
        *(jnp.asarray(a) for a in (dn.row, dn.note_idx, dn.acc, dn.duration,
                                   dn.velocity, dn.valid)),
        n_rows, n_notes, n_feat))
    got = raster_kernel.segment_rasterize_plain(
        *_torch_args(dn), n_rows, n_notes, n_feat).numpy()
    assert got.shape == (n_rows, n_notes * n_feat)
    np.testing.assert_array_equal(got, want_jnp)
    if n:
        # the Pallas kernel wants rows sorted AFTER invalid notes take the
        # sentinel row, as encode_notes leaves them
        row = np.where(dn.valid, dn.row, 2 ** 30).astype(np.int32)
        order = np.argsort(row, kind="stable")
        dn = jdr.DeviceNotes(row[order], *(a[order] for a in (
            dn.note_idx, dn.acc, dn.duration, dn.velocity, dn.valid)))
        want_pallas = np.asarray(pallas_rasterize(dn, n_rows, n_notes,
                                                  n_feat, interpret=True))
        np.testing.assert_array_equal(got, want_pallas)


def _edge_records(rng, n, n_rows, n_notes):
    """Unsorted pitched records whose values are edge cases of the max:
    negative durations and velocities, +-0.0, NaN of both signs and +-inf,
    with collisions, sentinel rows, rows past the raster and invalid notes
    (chip_smoke.py runs the same kinds of values on K1, and denormals too:
    XLA on the CPU flushes those to zero, torch and K1 keep them)."""
    edges = np.float32([-1.5, -0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf,
                        0.25, 3.0])
    row = rng.integers(0, n_rows + 4, n).astype(np.int32)
    row = np.where(rng.random(n) < 0.05, 2 ** 30, row).astype(np.int32)
    return jdr.DeviceNotes(
        row=row, note_idx=rng.integers(0, n_notes, n).astype(np.int32),
        acc=rng.integers(0, 3, n).astype(np.int32),
        duration=edges[rng.integers(0, len(edges), n)],
        velocity=edges[rng.integers(0, len(edges), n)],
        valid=rng.random(n) > 0.05)


def _kernel_rule(dn, n_rows, n_notes, n_feat):
    """K1's rule in numpy: a NaN becomes the canonical positive quiet NaN,
    then a signed-int max of the bit patterns on a zero base."""
    lanes = n_notes * n_feat
    out = np.zeros(n_rows * lanes, np.int32)
    keep = dn.valid & (dn.row >= 0) & (dn.row < n_rows)
    base = dn.row[keep].astype(np.int64) * lanes
    lane0 = dn.note_idx[keep].astype(np.int64) * n_feat
    pairs = [(lane0, dn.duration[keep]), (lane0 + 1, dn.velocity[keep])]
    if n_feat == 5:
        pairs.append((lane0 + 2 + dn.acc[keep],
                      np.ones(int(keep.sum()), np.float32)))
    for lane, value in pairs:
        bits = np.where(np.isnan(value), np.int32(0x7FC00000),
                        value.view(np.int32))
        inside = (lane >= 0) & (lane < lanes)
        np.maximum.at(out, base[inside] + lane[inside], bits[inside])
    return out.view(np.float32).reshape(n_rows, lanes)


def _assert_raster_bits(got, want):
    """NaN where ``want`` has NaN, equal bits everywhere else."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])


@pytest.mark.parametrize("n,n_rows", [(2000, 30), (400, 300)])
def test_raster_edge_values_bit_equal_to_jax_and_kernel_rule(n, n_rows):
    """Negative values, -0.0 and -inf lose to the zero base, +inf and NaN
    of either sign win, in the plain version, in mst_tpu's
    segment_rasterize and in the numpy model of K1's int-bit rule."""
    rng = np.random.default_rng(n + n_rows)
    dn = _edge_records(rng, n, n_rows, 56)
    got = raster_kernel.segment_rasterize_plain(
        *_torch_args(dn), n_rows, 56, 5).numpy()
    want_jax = np.asarray(jdr.segment_rasterize(
        *(jnp.asarray(a) for a in (dn.row, dn.note_idx, dn.acc, dn.duration,
                                   dn.velocity, dn.valid)), n_rows, 56, 5))
    rule = _kernel_rule(dn, n_rows, 56, 5)
    for want in (want_jax, rule):
        _assert_raster_bits(got, want)
    assert np.isnan(rule).any() and (rule == np.inf).any()
    assert not (np.signbit(rule) & ~np.isnan(rule)).any()


def test_raster_kernel_rule_matches_plain_on_ordinary_records():
    """On the records of the bit-equality test above (values >= 0), the
    numpy model of K1's rule gives the plain version's raster."""
    rng = np.random.default_rng(5)
    dn = _records(rng, 900, 200, 47, 2, spill_rows=20)
    got = raster_kernel.segment_rasterize_plain(
        *_torch_args(dn), 200, 47, 2).numpy()
    np.testing.assert_array_equal(got, _kernel_rule(dn, 200, 47, 2))


def test_raster_collisions_take_the_max():
    """Two notes on one cell: every lane keeps its max, accidentals OR."""
    dn = jdr.DeviceNotes(
        row=np.array([3, 3], np.int32), note_idx=np.array([2, 2], np.int32),
        acc=np.array([0, 2], np.int32),
        duration=np.array([1.5, 0.25], np.float32),
        velocity=np.array([0.2, 0.9], np.float32),
        valid=np.array([True, True]))
    out = raster_kernel.segment_rasterize_plain(
        *_torch_args(dn), 8, 4, 5).reshape(8, 4, 5)
    np.testing.assert_array_equal(out[3, 2].numpy(),
                                  np.float32([1.5, 0.9, 1.0, 0.0, 1.0]))
    assert float(out.sum()) == pytest.approx(1.5 + 0.9 + 2.0)


def test_segment_rasterize_on_cpu_takes_the_plain_version(example_song):
    """The port's segment_rasterize on CPU tensors equals mst_tpu's on the
    records of a real ingested song, and launches no kernel."""
    dn, n_rows = example_song
    before = raster_kernel.rasterize.launches
    got = device_raster.segment_rasterize(*_torch_args(dn), n_rows, 56, 5)
    want = jdr.segment_rasterize(
        *(jnp.asarray(a) for a in (dn.row, dn.note_idx, dn.acc, dn.duration,
                                   dn.velocity, dn.valid)), n_rows, 56, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert raster_kernel.rasterize.launches == before


@pytest.fixture(scope="module")
def example_song():
    """Both frameworks' host prep of one synthetic song gives the same
    records; returns them with the raster's row count."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_corpus import generate_song
    from mst_tpu.io import create_midi
    from mst_tpu.ops.events import read_midi as j_read
    from mst_tpu.data.pipeline import get_input as j_get_input
    from mst_tpu.ops.rasterize import Rasterizer as JR
    from mst_torch.ops.rasterize import Rasterizer as TR
    from mst_torch.data.pipeline import get_input as t_get_input
    from mst_torch.ops.events import read_midi as t_read
    from mst_torch.io import smf as t_smf
    from mst_tpu.io import smf as j_smf

    info, instruments = generate_song(np.random.default_rng(0))
    data = j_smf.encode_midi(create_midi(info, *instruments))
    j_song = j_get_input(*j_read(j_smf.parse_midi_bytes(data)))
    t_song = t_get_input(*t_read(t_smf.parse_midi_bytes(data)))
    C, R = j_song.pitched_shape[:2]
    T = j_song.info.n_beats

    def records(song, R_cls, encode, concat):
        r = R_cls(song.info)
        parts = [encode(r, r.quantize(n, True), c, True, C, R)
                 for c, n in enumerate(song.pitched_notes)]
        return concat(parts)

    j_dn = records(j_song, JR, jdr.encode_notes, jdr.concat_and_pad)
    t_dn = records(t_song, TR, device_raster.encode_notes,
                   device_raster.concat_and_pad)
    for field in ("row", "note_idx", "acc", "duration", "velocity", "valid"):
        np.testing.assert_array_equal(getattr(t_dn, field),
                                      getattr(j_dn, field))
    return j_dn, C * R * T * 10


def _sigmoid_err(got, want):
    """max |got - want| in units of the sigmoid, before the output scale."""
    return float((np.abs(got - want) / np.float32(SCALE)).max())


def _tail_inputs(rng, lead, full_rest=False):
    f = np.float32
    xo = rng.normal(size=lead + (8, 30)).astype(f)
    xd = rng.normal(size=lead + (7, 30)).astype(f)
    w = (rng.normal(size=(30, 5)) * 0.3).astype(f)
    rest_lead = lead if full_rest else (lead[0], 1) + lead[2:]
    rest = rng.normal(size=rest_lead + (56, 5)).astype(f)
    return xo, xd, w, rest


@pytest.mark.parametrize("lead,full_rest", [
    ((2, 3, 4, 2, 10), False),     # rest broadcast over the channel axis
    ((1, 1, 3, 4, 10), False),
    ((2, 3, 2, 1, 10), True),      # rest of the full lead shape
])
def test_grid_tail_plain_matches_unrolled_and_pallas(lead, full_rest):
    rng = np.random.default_rng(sum(lead))
    args = _tail_inputs(rng, lead, full_rest)
    got = grid_kernel.grid_tail_plain(*(torch.from_numpy(a) for a in args),
                                      SCALE).numpy()
    j_args = tuple(jnp.asarray(a) for a in args)
    unrolled = np.asarray(_tail_unrolled(*j_args, SCALE))
    pallas = np.asarray(fused_grid_tail(*j_args, SCALE, interpret=True))
    assert got.shape == lead + (56, 5)
    for want in (unrolled, pallas):
        assert _sigmoid_err(got, want) <= K2_ATOL


def test_grid_tail_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(7)
    args = tuple(torch.from_numpy(a)
                 for a in _tail_inputs(rng, (2, 3, 2, 2, 10)))
    before = grid_kernel.grid_tail.launches
    got = grid_kernel.grid_tail(*args, SCALE)
    assert torch.equal(got, grid_kernel.grid_tail_plain(*args, SCALE))
    assert grid_kernel.grid_tail.launches == before


def test_grid_tail_rest_layout():
    """Which rest row the kernel reads for each output row."""
    lead = (2, 3, 4, 2, 10)
    assert grid_kernel._rest_layout(lead, lead + (56, 5)) == (1, 1)
    assert grid_kernel._rest_layout(
        lead, (2, 1, 4, 2, 10, 56, 5)) == (3, 4 * 2 * 10)
    with pytest.raises(ValueError):
        grid_kernel._rest_layout(lead, (1, 1, 4, 2, 10, 56, 5))
    # the kernel's row mapping, replayed on the host: out row n reads
    # rest row (n // (rep * inner)) * inner + n % inner
    rep, inner = 3, 80
    n = np.arange(2 * rep * inner)
    b, c, m = np.unravel_index(n, (2, rep, inner))
    np.testing.assert_array_equal((n // (rep * inner)) * inner + n % inner,
                                  b * inner + m)


def _tile_rest_runs(r0, rows, rest_rep, rest_inner):
    """The (first rest row, row count) runs that K2's producer copies for
    the tile of ``rows`` output rows starting at row ``r0``, replayed from
    mst_torch/csrc/grid_tail.cu: one division for the tile, then steps that
    wrap at ``rest_inner``; with ``rest_rep`` 1 the tile's own rows."""
    if rest_rep == 1:
        return [(r0, rows)]
    q, m = divmod(r0, rest_inner)
    runs, done = [], 0
    while done < rows:
        count = min(rest_inner - m, rows - done)
        runs.append(((q // rest_rep) * rest_inner + m, count))
        done += count
        m = 0
        q += 1
    return runs


@pytest.mark.parametrize("lead,full_rest", [
    ((1, 3, 7, 3, 1), False),      # 63 rows, rest blocks of 21 rows
    ((2, 3, 1, 1, 5), False),      # 30 rows, rest blocks shorter than a tile
    ((2, 3, 4, 2, 10), False),     # 480 rows, rest blocks of 80 rows
    ((1, 3, 7, 3, 1), True),       # rest of the full lead shape
], ids=["63-rows", "inner-5", "480-rows", "full"])
def test_grid_tail_tile_rest_runs(lead, full_rest):
    """K2's tiles of 8 rows (the last one ragged) read, run by run, the
    rest rows that the per-row mapping gives every output row."""
    tail = (56, 5)
    rest_shape = (lead if full_rest else (lead[0], 1) + lead[2:]) + tail
    rep, inner = grid_kernel._rest_layout(lead, rest_shape)
    n = int(np.prod(lead))
    b, c, m = np.unravel_index(np.arange(n), (lead[0], lead[1],
                                              n // (lead[0] * lead[1])))
    want = (np.arange(n) if full_rest else b * (n // (lead[0] * lead[1]))
            + m)
    got = []
    for r0 in range(0, n, 8):
        runs = _tile_rest_runs(r0, min(8, n - r0), rep, inner)
        assert len(runs) <= 8
        for first, count in runs:
            got.extend(range(first, first + count))
    np.testing.assert_array_equal(got, want)


def test_grid_tail_rejects_wrong_widths():
    rng = np.random.default_rng(1)
    xo, xd, w, rest = (torch.from_numpy(a)
                       for a in _tail_inputs(rng, (1, 1, 1, 1, 10)))
    with pytest.raises(ValueError):
        grid_kernel.grid_tail(xo[..., :29], xd[..., :29], w[:29], rest, SCALE)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail(xo, xd, w, rest, SCALE[:4])


# ------------------------------------------- K3: the tail's backward
#
# grid_tail_bwd_plain (the plain version of K3) against the JAX package's
# two gradients of the tail: jax.vjp of fused_grid_tail(..., interpret=True)
# (the Pallas backward kernel _bwd_kernel, interpreted) and jax.grad of
# _tail_jnp (checkpointed autodiff), within tests/test_fused_tails.py's
# fp32-reassociation tolerance (rtol 1e-5, atol 1e-5 + 2e-6 * max|want|):
# ct_w and ct_rest sum over every row, in another order in each.

def _assert_grad_close(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 + 2e-6 * np.abs(want).max(),
                               err_msg=label)


@pytest.mark.parametrize("lead,full_rest", [
    ((2, 3, 4, 2, 5), False),      # rest broadcast over the channel axis
    ((1, 3, 7, 3, 1), False),      # 63 rows: not a multiple of any tile
    ((2, 2, 3, 1, 4), True),       # rest of the full lead shape
], ids=["broadcast", "63-rows", "full"])
def test_grid_tail_bwd_plain_matches_pallas_and_autodiff(lead, full_rest):
    from mst_tpu.ops.pallas_grid import _tail_jnp

    rng = np.random.default_rng(sum(lead) + full_rest)
    args = _tail_inputs(rng, lead, full_rest)
    ct = rng.normal(size=lead + (56, 5)).astype(np.float32)
    j_args = tuple(jnp.asarray(a) for a in args)
    out, vjp = jax.vjp(
        lambda *a: fused_grid_tail(*a, SCALE, interpret=True), *j_args)
    want_pallas = vjp(jnp.asarray(ct))
    want_jnp = jax.grad(lambda a: (_tail_jnp(*a, SCALE)
                                   * jnp.asarray(ct)).sum())(j_args)
    xo, xd, w, rest = (torch.from_numpy(a) for a in args)
    ct_xo, ct_xd, ct_y, ct_w = grid_kernel.grid_tail_bwd_plain(
        xo, xd, torch.from_numpy(np.array(out)), torch.from_numpy(ct), w,
        SCALE)
    ct_rest = ct_y if full_rest else ct_y.sum(dim=1, keepdim=True)
    got = (ct_xo, ct_xd, ct_w, ct_rest)
    for want in (want_pallas, want_jnp):
        for name, g, wv in zip(("xo", "xd", "w", "rest"), got, want):
            assert tuple(g.shape) == tuple(wv.shape), name
            _assert_grad_close(g.numpy(), wv, name)


@pytest.mark.parametrize("full_rest", [False, True])
def test_grid_tail_autograd_equals_plain_autograd(full_rest):
    """Autograd through GridTail (K2 + K3's plain versions on the CPU)
    equals torch autograd of grid_tail_plain, and counts no launch."""
    rng = np.random.default_rng(11 + full_rest)
    lead = (2, 3, 2, 2, 5)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _tail_inputs(rng, lead, full_rest)]
    ct = torch.from_numpy(rng.normal(size=lead + (56, 5)).astype(np.float32))
    before = (grid_kernel.grid_tail.launches,
              grid_kernel.grid_tail_bwd.launches)
    out = grid_kernel.grid_tail(*args, SCALE)
    got = torch.autograd.grad(out, args, ct)
    out_plain = grid_kernel.grid_tail_plain(*args, SCALE)
    want = torch.autograd.grad(out_plain, args, ct)
    assert torch.equal(out, out_plain)
    for name, g, wv in zip(("xo", "xd", "w", "rest"), got, want):
        assert g.shape == wv.shape, name
        _assert_grad_close(g.numpy(), wv.numpy(), name)
    assert (grid_kernel.grid_tail.launches,
            grid_kernel.grid_tail_bwd.launches) == before


def test_grid_tail_without_grad_saves_nothing():
    """Under inference_mode (the serving path) the tail runs the forward
    alone: no autograd node, the same values."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _tail_inputs(rng, (1, 2, 2, 1, 10))]
    with torch.inference_mode():
        out = grid_kernel.grid_tail(*args, SCALE)
    assert out.grad_fn is None
    with_grad = grid_kernel.grid_tail(*args, SCALE)
    assert type(with_grad.grad_fn).__name__ == "GridTailBackward"
    assert torch.equal(out, with_grad.detach())


def test_grid_tail_bwd_rejects_wrong_shapes():
    rng = np.random.default_rng(4)
    xo, xd, w, _ = (torch.from_numpy(a)
                    for a in _tail_inputs(rng, (1, 1, 1, 1, 10)))
    out = torch.zeros(1, 1, 1, 1, 10, 56, 5)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail_bwd(xo, xd, out[..., :4], out, w, SCALE)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail_bwd(xo, xd, out, out[:, :, :, :, :9], w, SCALE)


def test_grid_tail_bwd_on_cpu_takes_the_plain_version():
    """grid_tail_bwd on CPU tensors returns grid_tail_bwd_plain's four
    cotangents, bit for bit, and counts no launch."""
    rng = np.random.default_rng(8)
    lead = (1, 3, 7, 3, 1)
    xo, xd, w, rest = (torch.from_numpy(a) for a in _tail_inputs(rng, lead))
    out = grid_kernel.grid_tail_plain(xo, xd, w, rest, SCALE)
    ct = torch.from_numpy(rng.normal(size=lead + (56, 5)).astype(np.float32))
    before = grid_kernel.grid_tail_bwd.launches
    got = grid_kernel.grid_tail_bwd(xo, xd, out, ct, w, SCALE)
    want = grid_kernel.grid_tail_bwd_plain(xo, xd, out, ct, w, SCALE)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert grid_kernel.grid_tail_bwd.launches == before


# K3's persistent schedule (csrc/grid_tail_bwd.cu), replayed: a grid of
# bwd_grid(...) blocks; block b takes the 8-row tiles b, b + grid, ...
K3_ROWS = 8


def _k3_block_tiles(n, grid):
    """{block: [(first row, rows), ...]} in the order each block walks."""
    tiles = -(-n // K3_ROWS)
    return {b: [(t * K3_ROWS, min(K3_ROWS, n - t * K3_ROWS))
                for t in range(b, tiles, grid)] for b in range(grid)}


@pytest.mark.parametrize("per_sm,sms", [(1, 1), (1, 132), (2, 132)],
                         ids=["grid-1", "grid-132", "grid-264"])
@pytest.mark.parametrize("n", [1, 7, 8, 63, 10_240])
def test_grid_tail_bwd_schedule_covers_every_row_once(n, per_sm, sms):
    """Every row lies in exactly one tile of one block; no block is
    empty; only the last tile is short, and it is the last of its block."""
    grid = grid_kernel.bwd_grid(n, per_sm, sms, K3_ROWS)
    tiles = -(-n // K3_ROWS)
    assert grid == min(per_sm * sms, tiles)
    schedule = _k3_block_tiles(n, grid)
    seen = np.zeros(n, np.int64)
    for b, walk in schedule.items():
        assert walk, f"block {b} has no tile"
        for first, rows in walk:
            seen[first:first + rows] += 1
    np.testing.assert_array_equal(seen, 1)
    last_first, last_rows = max(t for walk in schedule.values() for t in walk)
    assert last_rows == (n % K3_ROWS or K3_ROWS)
    short = [(b, walk.index(t)) for b, walk in schedule.items()
             for t in walk if t[1] < K3_ROWS]
    assert len(short) == (1 if n % K3_ROWS else 0)
    for b, at in short:
        assert at == len(schedule[b]) - 1


def _k3_ct_w_replay(xo, xd, ct_y, grid):
    """K3's ct_w in its own summation order, in numpy: per row, a tile
    partial over the 56 (o, d) in order (a fused multiply-add each,
    emulated in float64 and rounded to fp32); per block and row slot, a
    running sum of its tiles' partials; per block, the 8 slots in
    ascending order; then the block partials in ascending order."""
    f32 = np.float32
    n = xo.shape[0]
    leaky = lambda x: np.where(x > 0, x, x * f32(0.01))
    gp = leaky(xo)[:, :, None, :] + leaky(xd)[:, None, :, :]
    lr = leaky(gp).reshape(n, 56, 30)
    cty = ct_y.reshape(n, 56, 5)
    part = np.full((n, 30, 5), -0.0, f32)
    for m in range(56):
        part = (lr[:, m, :, None].astype(np.float64) * cty[:, m, None, :]
                + part).astype(f32)
    blocks = []
    for walk in _k3_block_tiles(n, grid).values():
        run = np.zeros((K3_ROWS, 30, 5), f32)
        for first, rows in walk:
            run[:rows] = run[:rows] + part[first:first + rows]
        acc = run[0]
        for slot in range(1, K3_ROWS):
            acc = acc + run[slot]
        blocks.append(acc)
    total = blocks[0]
    for b in blocks[1:]:
        total = total + b
    return total


@pytest.mark.parametrize("lead,grid", [
    ((1, 3, 10, 1, 10), 5),        # 300 rows: 38 tiles, the last of 4 rows
    ((2, 2, 4, 2, 5), 3),          # 160 rows: whole tiles only
], ids=["300-rows", "160-rows"])
def test_grid_tail_bwd_ct_w_order_matches_plain_and_pallas(lead, grid):
    """K3's ct_w summation order (tile partials, per-block running sums,
    fixed-order sums of the slots and of the block partials) gives
    grid_tail_bwd_plain's ct_w and the Pallas backward's, within
    tests/test_fused_tails.py's tolerance."""
    rng = np.random.default_rng(sum(lead) + grid)
    args = _tail_inputs(rng, lead)
    ct = rng.normal(size=lead + (56, 5)).astype(np.float32)
    j_args = tuple(jnp.asarray(a) for a in args)
    out, vjp = jax.vjp(
        lambda *a: fused_grid_tail(*a, SCALE, interpret=True), *j_args)
    want_pallas = np.asarray(vjp(jnp.asarray(ct))[2])
    xo, xd, w, _ = (torch.from_numpy(a) for a in args)
    _, _, ct_y, want_plain = grid_kernel.grid_tail_bwd_plain(
        xo, xd, torch.from_numpy(np.array(out)), torch.from_numpy(ct), w,
        SCALE)
    n = int(np.prod(lead))
    got = _k3_ct_w_replay(args[0].reshape(n, 8, 30),
                          args[1].reshape(n, 7, 30),
                          ct_y.numpy().reshape(n, 56, 5), grid)
    _assert_grad_close(got, want_plain.numpy(), "plain")
    _assert_grad_close(got, want_pallas, "pallas")


# ------------------------------------------------- the bf16 forms

def _jax_records(dn):
    return tuple(jnp.asarray(a) for a in (dn.row, dn.note_idx, dn.acc,
                                          dn.duration, dn.velocity, dn.valid))


def _bf16_bits(x):
    """The 16-bit patterns of a bf16 array or tensor, as int16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("n_notes,n_feat", [(56, 5), (47, 2)])
@pytest.mark.parametrize("n,n_rows", [(300, 40), (900, 1100)])
def test_raster_bf16_plain_is_the_cast_and_matches_jax(n, n_rows, n_notes,
                                                       n_feat):
    """K1's bf16 plain version is its fp32 plain version cast to bf16, and
    mst_tpu's segment_rasterize and Pallas raster at out_dtype=bfloat16
    (tests/test_device_raster.py:108-127), bit for bit; on the CPU it
    launches nothing."""
    rng = np.random.default_rng(n + n_rows + n_feat + 1)
    dn = _records(rng, n, n_rows, n_notes, n_feat, spill_rows=n_rows // 8)
    before = raster_kernel.rasterize.launches_bf16
    got = raster_kernel.rasterize(*_torch_args(dn), n_rows, n_notes, n_feat,
                                  out_dtype=BF16)
    assert raster_kernel.rasterize.launches_bf16 == before
    assert got.dtype == BF16 and tuple(got.shape) == (n_rows,
                                                      n_notes * n_feat)
    cast = raster_kernel.segment_rasterize_plain(
        *_torch_args(dn), n_rows, n_notes, n_feat).to(BF16)
    want_jnp = jdr.segment_rasterize(*_jax_records(dn), n_rows, n_notes,
                                     n_feat, out_dtype=jnp.bfloat16)
    row = np.where(dn.valid, dn.row, 2 ** 30).astype(np.int32)
    order = np.argsort(row, kind="stable")
    sorted_dn = jdr.DeviceNotes(row[order], *(a[order] for a in (
        dn.note_idx, dn.acc, dn.duration, dn.velocity, dn.valid)))
    want_pallas = pallas_rasterize(sorted_dn, n_rows, n_notes, n_feat,
                                   interpret=True, out_dtype=jnp.bfloat16)
    for want in (_bf16_bits(cast), _bf16_bits(want_jnp),
                 _bf16_bits(want_pallas)):
        np.testing.assert_array_equal(_bf16_bits(got), want)


def _kernel_rule_bf16(dn, n_rows, n_notes, n_feat):
    """K1's bf16 rule in numpy: each value rounded to bf16 (round to
    nearest even; a NaN becomes the canonical 0x7FC0), then a signed 16-bit
    max of the patterns on a zero base."""
    lanes = n_notes * n_feat
    out = np.zeros(n_rows * lanes, np.int16)
    keep = dn.valid & (dn.row >= 0) & (dn.row < n_rows)
    base = dn.row[keep].astype(np.int64) * lanes
    lane0 = dn.note_idx[keep].astype(np.int64) * n_feat
    pairs = [(lane0, dn.duration[keep]), (lane0 + 1, dn.velocity[keep])]
    if n_feat == 5:
        pairs.append((lane0 + 2 + dn.acc[keep],
                      np.ones(int(keep.sum()), np.float32)))
    for lane, value in pairs:
        u = value.view(np.uint32).astype(np.uint64)
        rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        bits = np.where(np.isnan(value), np.int16(0x7FC0),
                        rounded.view(np.int16))
        inside = (lane >= 0) & (lane < lanes)
        np.maximum.at(out, base[inside] + lane[inside], bits[inside])
    return out.reshape(n_rows, lanes)


@pytest.mark.parametrize("n,n_rows", [(2000, 30), (400, 300)])
def test_raster_bf16_edge_values_match_the_kernel_rule(n, n_rows):
    """On edge values (negatives, +-0.0, NaN of both signs, +-inf) the
    bf16 plain version, mst_tpu's bf16 segment_rasterize and the numpy
    model of K1's 16-bit compare-and-swap rule agree: NaN in the same
    cells, the same bits elsewhere."""
    rng = np.random.default_rng(n + n_rows + 2)
    dn = _edge_records(rng, n, n_rows, 56)
    got = _bf16_bits(raster_kernel.segment_rasterize_plain(
        *_torch_args(dn), n_rows, 56, 5, out_dtype=BF16))
    want_jax = _bf16_bits(jdr.segment_rasterize(
        *_jax_records(dn), n_rows, 56, 5, out_dtype=jnp.bfloat16))
    rule = _kernel_rule_bf16(dn, n_rows, 56, 5)

    def nan(bits):
        return ((bits & 0x7F80) == 0x7F80) & ((bits & 0x7F) != 0)

    for want in (want_jax, rule):
        np.testing.assert_array_equal(nan(got), nan(want))
        np.testing.assert_array_equal(got[~nan(want)], want[~nan(want)])
    assert nan(rule).any() and (rule == 0x7F80).any()
    assert not ((rule < 0) & ~nan(rule)).any()


def _bf16_tail_case(lead, full_rest):
    """Tail inputs with bf16 xo and xd, for both frameworks, and a bf16
    cotangent of the (bf16-stored) output."""
    rng = np.random.default_rng(sum(lead) + full_rest + 20)
    xo, xd, w, rest = _tail_inputs(rng, lead, full_rest)
    ct = rng.normal(size=lead + (56, 5)).astype(np.float32)
    j = (jnp.asarray(xo, jnp.bfloat16), jnp.asarray(xd, jnp.bfloat16),
         jnp.asarray(w), jnp.asarray(rest))
    t = tuple(torch.from_numpy(np.array(a.astype(jnp.float32))).to(d)
              for a, d in zip(j, (BF16, BF16, torch.float32, torch.float32)))
    j_ct = jnp.asarray(ct, jnp.bfloat16)
    t_ct = torch.from_numpy(np.array(j_ct.astype(jnp.float32))).to(BF16)
    return j, t, j_ct, t_ct


@pytest.mark.parametrize("lead,full_rest", [
    ((2, 3, 4, 2, 5), False),
    ((1, 3, 7, 3, 1), False),
    ((2, 2, 3, 1, 4), True),
], ids=["broadcast", "63-rows", "full"])
def test_bf16_tail_plain_tracks_jax_tail_and_its_gradients(lead, full_rest):
    """The bf16 form against mst_tpu's tail under bf16 storage: its jnp
    tail on bf16 xo/xd with the output cast to bf16 (appliers.py:85-89) and
    jax.grad of that (tests/test_fused_tails.py:130-145).

    - Forward: within one bf16 rounding of JAX's output (|diff| <= 2**-8
      |want|): the two K-sums are fp32 sums in other orders, which may
      land on the two sides of a rounding boundary (0 values differed when
      this test was written).
    - Dtypes: ct_xo and ct_xd bf16, ct_w and ct_rest fp32.
    - Gradients: within 2e-2 of each cotangent's largest |value|. Two
      effects, measured when this test was written: the bf16 sums over d
      and o, which XLA's CPU backend rounds elsewhere than the kernel's
      fp32 accumulation (ct_xo, ct_xd 0.5-1.1% of the largest value,
      whatever the saved output); and the saved output, which the bf16
      form takes at bf16 where JAX recomputes it at fp32 (ct_w, ct_rest:
      0.4-1.2% with the bf16 output, under 2e-5 with JAX's fp32 output, as
      the last check shows)."""
    from mst_tpu.ops.pallas_grid import _tail_jnp

    j, t, j_ct, t_ct = _bf16_tail_case(lead, full_rest)

    def j_out(*a):
        return _tail_jnp(*a, SCALE).astype(jnp.bfloat16)

    want = np.asarray(j_out(*j).astype(jnp.float32))
    out = grid_kernel.grid_tail_plain(*t, SCALE)
    assert out.dtype == BF16
    got = out.float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want)).all()

    want_g = jax.grad(lambda *a: (j_out(*a).astype(jnp.float32)
                                  * j_ct.astype(jnp.float32)).sum(),
                      argnums=(0, 1, 2, 3))(*j)
    assert [str(g.dtype) for g in want_g] == ["bfloat16", "bfloat16",
                                              "float32", "float32"]

    def grads(saved_out):
        ct_xo, ct_xd, ct_y, ct_w = grid_kernel.grid_tail_bwd_plain(
            t[0], t[1], saved_out, t_ct, t[2], SCALE)
        ct_rest = ct_y if full_rest else ct_y.sum(dim=1, keepdim=True)
        return ct_xo, ct_xd, ct_w, ct_rest

    got_g = grads(out)
    assert [g.dtype for g in got_g] == [BF16, BF16, torch.float32,
                                        torch.float32]
    for name, g, w in zip(("xo", "xd", "w", "rest"), got_g, want_g):
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
    # the cost of saving the bf16 output: with JAX's fp32 output the
    # parameter cotangents agree to fp32 reassociation
    out32 = torch.from_numpy(np.array(_tail_jnp(*j, SCALE)))
    for name, g, w in zip(("w", "rest"), grads(out32)[2:], want_g[2:]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-5 * np.abs(w).max(), name


def test_grid_tail_bf16_autograd_dtypes_and_plain_cotangents():
    """GridTail in its bf16 form on the CPU: a bf16 output, and a backward
    that returns grid_tail_bwd_plain's cotangents in the inputs' dtypes,
    counting no launch."""
    _, t, _, t_ct = _bf16_tail_case((2, 3, 2, 2, 5), False)
    leaves = [a.clone().requires_grad_(True) for a in t]
    before = (grid_kernel.grid_tail.launches_bf16,
              grid_kernel.grid_tail_bwd.launches_bf16)
    out = grid_kernel.grid_tail(*leaves, SCALE)
    assert out.dtype == BF16
    got = torch.autograd.grad(out, leaves, t_ct)
    assert [g.dtype for g in got] == [a.dtype for a in t]
    ct_xo, ct_xd, ct_y, ct_w = grid_kernel.grid_tail_bwd_plain(
        t[0], t[1], out.detach(), t_ct, t[2], SCALE)
    for g, w in zip(got, (ct_xo, ct_xd, ct_w,
                          ct_y.sum(dim=1, keepdim=True))):
        assert torch.equal(g, w)
    assert (grid_kernel.grid_tail.launches_bf16,
            grid_kernel.grid_tail_bwd.launches_bf16) == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_tail_wrappers_reject_dtypes_the_kernels_do_not_take(dtype):
    """A dtype that no kernel form takes raises; nothing is converted."""
    rng = np.random.default_rng(6)
    xo, xd, w, rest = (torch.from_numpy(a)
                       for a in _tail_inputs(rng, (1, 1, 1, 1, 10)))
    out = grid_kernel.grid_tail_plain(xo, xd, w, rest, SCALE)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail(xo.to(dtype), xd.to(dtype), w, rest, SCALE)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail_bwd(xo.to(dtype), xd.to(dtype), out, out, w,
                                  SCALE)
    # a mixed form is no form either: bf16 xo with fp32 xd, bf16 w, or an
    # fp32 output and cotangent against bf16 embeddings
    with pytest.raises(ValueError):
        grid_kernel.grid_tail(xo.to(BF16), xd, w, rest, SCALE)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail(xo, xd, w.to(BF16), rest, SCALE)
    with pytest.raises(ValueError):
        grid_kernel.grid_tail_bwd(xo.to(BF16), xd.to(BF16), out, out, w,
                                  SCALE)
    with pytest.raises(ValueError):
        raster_kernel.rasterize(*(torch.zeros(1, dtype=d) for d in (
            torch.int32, torch.int32, torch.int32, torch.float32,
            torch.float32, torch.bool)), 1, 56, 5, out_dtype=dtype)
