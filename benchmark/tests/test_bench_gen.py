"""The input generator repeats exactly for a seed, imports neither
package, and its songs take the shapes each cell means to measure."""

import hashlib
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.gen import songs


def _digest(blobs):
    return hashlib.sha256(b"".join(blobs)).hexdigest()


def test_same_seed_same_bytes():
    a, _ = songs.make_pool(2 ** 31 + 11, 5)
    b, _ = songs.make_pool(2 ** 31 + 11, 5)
    c, _ = songs.make_pool(2 ** 31 + 12, 5)
    assert _digest(a) == _digest(b) != _digest(c)


def test_generator_imports_neither_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.gen.songs as s; s.make_pool(3, 2); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'mst_tpu', 'mst_torch'}))" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("cell", ["serve.fp32.r3x3", "train.fp32.b1",
                                  "train.bf16.b6"])
def test_songs_pass_the_cell_filter(cell):
    """4/4, percussion, 2-3 pitched channels, 65-128 bars: every song of
    the mix's sizes, parsed back by the reference's ingest."""
    from benchmark.reference import serve_ref
    mix = harness.Cell(cell).mix
    sizes = [dict(numer=s[0], n_bars=s[1], n_pitched=s[2], drums=bool(s[3]))
             for s in mix["sizes"]][:8]
    blobs, summaries = songs.make_pool(17, len(sizes), sizes=sizes)
    for blob, summary, size in zip(blobs, summaries, sizes):
        assert summary["numerator"] == 4 and summary["percussion"]
        assert 2 <= summary["pitched_channels"] <= 3
        assert 65 <= summary["bars"] <= 128 and summary["bars"] == \
            size["n_bars"]
        song = serve_ref.ingest(blob)
        assert song.n_channels == summary["pitched_channels"]
        assert song.has_unpitched and song.info.n_beats == 4
        assert song.n_bars <= 128      # the 128-bar bucket


def test_serve_plan_keeps_to_its_key():
    """Every planned request takes the mix's extraction shapes."""
    from benchmark.reference import serve_ref
    cell = harness.Cell("serve.fp32.r3x3")
    ctx = harness.Context(cell, 2 ** 31 + 5, 1.0, False, 0.0)
    try:
        driver = harness.load_module(
            ctx.path("traffic", "serve_closed_loop.py"), "serve")
        comp = [serve_ref.ingest(b) for b in
                driver._pool(ctx, 1, cell.mix["pool"], cell.mix["sizes"])]
        style = [serve_ref.ingest(b) for b in
                 driver._pool(ctx, 2, cell.mix["pool"], cell.mix["sizes"])]
        plan = driver.plan_requests(ctx, comp, style, 50)
    finally:
        ctx.close()
    for c, s in plan:
        key = serve_ref.host_key([comp[i] for i in c] + [style[i] for i in s])
        assert key == (4, True, 8) + tuple(cell.mix["key"])
