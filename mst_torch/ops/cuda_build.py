"""Build and load the port's hand-written CUDA kernels.

Each kernel is one file ``mst_torch/csrc/<name>.cu`` with a plain C entry
point; it may include the shared headers ``csrc/*.cuh``. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/mst_torch_kernels/`` at the root of the checkout and loaded with
ctypes. The library's file name carries a hash of the source, the shared
headers and the flags, so an edited source or header is rebuilt and a
stale build is never loaded. A failed build raises; nothing falls back to
plain torch.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them: that is how ``chip_smoke.py`` builds every kernel of the main path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "mst_torch", "csrc")
BUILD_DIR = os.path.join(ROOT, "build", "mst_torch_kernels")

BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per-kernel flags. The grid tail's forward and backward are built without
# multiply-add contraction so that their ordered sums round exactly like the
# plain torch versions (a separate multiply and add per term) and the two
# agree bit for bit. So is the LSTM recurrence, whose cell update then
# rounds as the plain loop's separate kernels do (its dot product uses
# explicit fused multiply-adds). The melody tail contracts its products and
# biases into fused multiply-adds (--fmad=true, nvcc's default, said here):
# the composition it stands for sums its products in cuBLAS's order, so no
# choice gives its bits, and it is held to the fp32-reassociation rule.
# The packing and compaction kernel is built without contraction too: its
# words are the composition's bits, each multiply rounded alone.
KERNEL_FLAGS = {
    "raster": (),
    "grid_tail": ("--fmad=false",),
    "grid_tail_bwd": ("--fmad=false",),
    "lstm_recur": ("--fmad=false",),
    "melody_tail": ("--fmad=true",),
    "pack_compact": ("--fmad=false",),
}

_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of mst_torch are "
                       "built with nvcc on the machine with the GPU")


def _flags(name: str) -> Tuple[str, ...]:
    return BASE_FLAGS + KERNEL_FLAGS[name]


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives. The hash
    covers the source, every shared header of ``csrc/`` and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one kernel; returns (process, temp output, target)
    or None when the library is already built."""
    target = library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(name), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    _logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names: Iterable[str] = tuple(KERNEL_FLAGS)) -> Dict[str, str]:
    """Build every named kernel, one nvcc process each, all in parallel.
    Returns {name: compiler output} (ptxas register and spill report) for
    the kernels built by this call."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return {n: _logs[n] for n in names if started[n] is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
