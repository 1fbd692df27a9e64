"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port. Each check runs in a process of its
own, so that other tests' imports cannot hide or fake a result."""

import glob
import os
import re
import subprocess
import sys

from benchmark import harness

DRY_RUN = r"""
import sys, time
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import conftest
from benchmark import harness
import benchmark.gen.songs, benchmark.measure.trace
import benchmark.measure.roofline, benchmark.reference.serve_ref
import benchmark.reference.train_ref, benchmark.tests.controls
serve = harness.Cell("serve.fp32.r3x3")
serve.mix = dict(serve.mix, compositions=1, styles=1, pool=2,
                 sizes=[[4, 20, 2, 1], [4, 24, 3, 1]], key=[64, 512, 2048],
                 requests=2, warmup_cycles=[1, 1], sample=1)
for cell in (serve, conftest.tiny_train_cell("train.fp32.b1", 1),
             conftest.tiny_train_cell("train.bf16.b6", 2)):
    line = harness.execute(cell, 2 ** 31 + 3, 0.2, False,
                           time.perf_counter(), device="cpu")
    assert line["attempted"] >= 1, line
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}
                       & {"jax", "jaxlib", "flax", "mst_tpu"}))
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=harness.ROOT)


def test_dry_run_loads_no_jax():
    """The harness, generator, reference and yardstick modules, and a
    tiny CPU run of both drivers (the kernels' plain versions)."""
    out = _run(DRY_RUN % {"root": harness.ROOT,
                          "tests": os.path.dirname(__file__)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("mst_tpu_like", type(sys)("mst_tpu_like"))
    try:
        assert "mst_tpu_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["mst_tpu_like"]


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.serve_ref, "
            "benchmark.reference.train_ref, benchmark.measure.trace, "
            "benchmark.measure.roofline, benchmark.gen.songs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mst_torch', 'mst_tpu', 'jax', 'jaxlib'}))" % harness.ROOT)
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_reference_sources_name_no_port_module():
    pattern = re.compile(r"^\s*(from|import)\s+(mst_torch|mst_tpu|jax)\b",
                         re.M)
    root = os.path.join(harness.HERE, "reference")
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        with open(path) as fh:
            assert not pattern.search(fh.read()), path
