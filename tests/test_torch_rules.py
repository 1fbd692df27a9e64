"""Ground rules of the port, checked on the CPU.

- ``mst_torch``, ``chip_smoke.py``, the port's CLIs (``*-torch.py``) and
  its tools (``tools/*_torch.py``) import neither JAX, flax, optax,
  orbax, tqdm nor anything of ``mst_tpu``, nor a tool of the JAX package:
  the machine with the GPU has none of them.
- Entry points run on the GPU unless the caller asks for the CPU, and
  raise rather than run quietly on the CPU.
- A CUDA kernel's wrapper takes its plain version only for CPU tensors;
  for any other tensor it launches the kernel or raises.
- A program whose CUDA graph capture fails raises; it never runs eagerly
  on the card in the graph's place.
"""

import ast
import contextlib
import os
import subprocess
import sys

import pytest
import torch

from mst_torch import transfer
from mst_torch.config import ModelConfig
from mst_torch.models import StyleTransferModel
from mst_torch.ops import cuda_build, grid_kernel, raster_kernel
from mst_torch.runtime import programs
from tests.test_torch_model import NARROW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "tqdm", "mst_tpu")
# the JAX package's tools, which import it
JAX_TOOLS = tuple(name[:-3] for name in os.listdir(TOOLS)
                  if name.endswith(".py") and not name.endswith("_torch.py"))
# torch itself imports tqdm where it is installed (torch.hub), so the
# import check below leaves it out; the source check forbids it
FORBIDDEN_MODULES = tuple(m for m in FORBIDDEN if m != "tqdm")


def test_import_pulls_in_no_jax():
    code = ("import sys; import mst_torch, mst_torch.transfer, "
            "mst_torch.weights, mst_torch.parity, mst_torch.runtime.train, "
            "mst_torch.runtime.checkpoint, mst_torch.runtime.metrics, "
            "mst_torch.data.cache, mst_torch.data.prefetch, "
            "mst_torch.audio, mst_torch.audio.mp3, mst_torch.analysis, "
            "mst_torch.utils, mst_torch.runtime.ref_checkpoint, "
            "mst_torch.parallel, mst_torch.parallel.seq_lstm, "
            "mst_torch.runtime.flops, mst_torch.ops.flop_scope, "
            "mst_torch.runtime.profile, mst_torch.runtime.programs, "
            "parse_profile_torch, "
            "profile_transfer_torch, profile_transfer_device_torch; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN_MODULES!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((ROOT, TOOLS)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_flops_import_alone_pulls_in_no_jax():
    """The FLOP counter on its own (its tests import mst_tpu's beside it)."""
    code = ("import sys; import mst_torch.runtime.flops; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN_MODULES!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "mst_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    for name in ("chip_smoke.py", "train-model-torch.py",
                 "style-transfer-torch.py", "batch-style-transfer-torch.py",
                 "corpus-stats-torch.py"):
        yield os.path.join(ROOT, name)
    for name in sorted(os.listdir(TOOLS)):
        if name.endswith("_torch.py"):
            yield os.path.join(TOOLS, name)


def test_no_source_imports_jax_or_mst_tpu():
    checked = 0
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
                assert name.split(".")[-1] not in JAX_TOOLS, (path, name)
        checked += 1
    assert checked > 40


def test_bundle_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        transfer.ModelBundle(model=StyleTransferModel())
    with pytest.raises(RuntimeError, match="CUDA"):
        transfer.ModelBundle.from_npz()
    bundle = transfer.ModelBundle(model=StyleTransferModel(), device="cpu")
    assert bundle.device.type == "cpu"
    # the transfer entry pins full fp32 on the card
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert transfer.transfer_styles(bundle, [], [], str(tmp_path)) == []
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _meta(*tensors):
    """Tensors off the CPU, as a CUDA tensor would be: the wrapper must not
    take its plain version for them."""
    return tuple(t.to("meta") for t in tensors)


def _raster_args():
    n = 4
    return _meta(torch.zeros(n, dtype=torch.int32),
                 torch.zeros(n, dtype=torch.int32),
                 torch.zeros(n, dtype=torch.int32),
                 torch.zeros(n), torch.zeros(n),
                 torch.ones(n, dtype=torch.bool))


def _tail_args():
    lead = (1, 2, 1, 1, 10)
    return _meta(torch.zeros(*lead, 8, 30), torch.zeros(*lead, 7, 30),
                 torch.zeros(30, 5), torch.zeros(1, 1, 1, 1, 10, 56, 5))


def test_wrappers_raise_without_the_kernel_library(monkeypatch):
    """With the library absent (the loader raises), a non-CPU tensor gets an
    error, never the plain version, and no launch is counted."""
    def absent(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    monkeypatch.setattr(cuda_build, "load", absent)
    counters = (raster_kernel.rasterize, grid_kernel.grid_tail,
                grid_kernel.grid_tail_bwd)
    before = [c.launches for c in counters]
    scale = (6.0, 1.0, 1.0, 1.0, 1.0)
    with pytest.raises(OSError):
        raster_kernel.rasterize(*_raster_args(), 8, 56, 5)
    with pytest.raises(OSError):
        grid_kernel.grid_tail(*_tail_args(), scale)
    xo, xd, w, _ = _tail_args()
    out = torch.zeros(1, 2, 1, 1, 10, 56, 5, device="meta")
    with pytest.raises(OSError):
        grid_kernel.grid_tail_bwd(xo, xd, out, out, w, scale)
    assert [c.launches for c in counters] == before


def test_failed_capture_raises_and_never_runs_eagerly(monkeypatch):
    """A program of a card bundle with ``capture=True`` whose capture fails
    raises, and its body runs only as the capture's warm-up, on the side
    stream: never eagerly in the graph's place. The card is faked: its
    streams and pool are stand-ins, the static inputs stay on the CPU,
    and ``torch.cuda.graph`` refuses the capture."""
    on_side_stream = [False]

    class Stream:
        def __init__(self, *args, **kwargs):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def side(stream):
        on_side_stream[0] = True
        try:
            yield
        finally:
            on_side_stream[0] = False

    def refuse(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", side)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(programs.Programs, "_static_input",
                        lambda self, leaf: leaf.clone())
    runs = []
    body = transfer._raster_extract_latents

    def recorded(*args, **kwargs):
        runs.append("warm-up" if on_side_stream[0] else "eager")
        return body(*args, **kwargs)

    monkeypatch.setattr(transfer, "_raster_extract_latents", recorded)
    bundle = transfer.ModelBundle(
        model=StyleTransferModel(ModelConfig(**NARROW)), device="cpu")
    bundle.programs = programs.Programs("cuda")
    assert bundle.capture
    song = transfer.get_model_input(os.path.join(
        ROOT, "mst_torch", "assets", "smoke", "comp_0.mid"))[1]
    (inputs,), statics, _ = transfer._extract_shards(
        bundle, [song], song.info.n_beats, song.unpitched_shape is not None)
    before = [getattr(fn, attr) for fn, attr in programs.COUNTERS]
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="capture failed"):
            bundle.fn("raster_extract")(*inputs, **statics)
        assert runs == ["warm-up"] * attempt
    assert bundle.programs.graphs == {}
    assert [getattr(fn, attr) for fn, attr in programs.COUNTERS] == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler: building a kernel raises; nothing falls back."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else
                        os.path.isfile(p))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load("raster")


def test_library_name_follows_source_and_flags():
    """A rebuilt source or changed flags never load a stale library."""
    paths = {name: cuda_build.library_path(name)
             for name in cuda_build.KERNEL_FLAGS}
    assert sorted(paths) == ["grid_tail", "grid_tail_bwd", "lstm_recur",
                             "melody_tail", "pack_compact", "raster"]
    assert len(set(paths.values())) == 6
    assert all(os.path.dirname(p) == cuda_build.BUILD_DIR
               for p in paths.values())
    assert cuda_build.BUILD_DIR.startswith(ROOT)
    assert "--fmad=false" in cuda_build._flags("grid_tail")
    assert "--fmad=false" in cuda_build._flags("grid_tail_bwd")
    assert "--fmad=false" in cuda_build._flags("lstm_recur")
    assert "--fmad=true" in cuda_build._flags("melody_tail")
    assert "--fmad=false" in cuda_build._flags("pack_compact")
    assert "arch=compute_90a,code=sm_90a" in cuda_build._flags("raster")


def test_library_name_follows_shared_headers(monkeypatch, tmp_path):
    """Editing a shared header (csrc/*.cuh) renames every library, so a
    kernel that includes it is rebuilt."""
    for name in os.listdir(cuda_build.CSRC):
        (tmp_path / name).write_bytes(
            open(os.path.join(cuda_build.CSRC, name), "rb").read())
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    assert (tmp_path / "tile_ring.cuh").exists()
    before = {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_FLAGS}
    with open(tmp_path / "tile_ring.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_FLAGS}
    assert all(before[n] != after[n] for n in before)


def test_sass_loop_bodies():
    """tools/sass_opcodes.py finds a loop's body from its backward branch
    and leaves out the idle branch-to-self after EXIT."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sass_opcodes

    listing = """
        Function : _Z6kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R8, R4, R5, R8 ;
        /*0030*/              @P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
    """
    listing = "\n".join(line.strip() for line in listing.splitlines())
    fns = sass_opcodes.functions(listing)
    assert list(fns) == ["_Z6kernelv"]
    assert fns["_Z6kernelv"][0] == (0, "MOV R1, c[0x0][0x28]")
    bodies = sass_opcodes.loops(fns["_Z6kernelv"])
    assert len(bodies) == 1
    assert dict(sass_opcodes.count(bodies[0])) == {"LDS": 1, "FFMA": 1,
                                                   "BRA": 1}
