"""Joining the ranks of a run, and each rank's share of the corpus.

Counterpart of mst_tpu/parallel/multihost.py. One process runs per rank
(``torchrun --nproc-per-node N`` or an equivalent set of variables);
``initialize_multihost`` forms the default process group from its
arguments or from the standard ``MASTER_ADDR``, ``RANK`` and
``WORLD_SIZE`` variables, after which mst_torch.parallel.mesh lays the
ranks out on a (data, seq) mesh.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mst_torch.device import resolve_device


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) passes as it is."""
    return address if "://" in address else f"tcp://{address}"


def default_backend(device=None) -> str:
    """The collectives' backend for ranks on ``device`` (default ``cuda``):
    ``gloo`` on the CPU, and when this host's ranks (``LOCAL_WORLD_SIZE``)
    outnumber its cards, since NCCL takes no two ranks on one card;
    ``nccl`` otherwise. ``cuda`` without a card raises."""
    if torch.device(device or "cuda").type != "cuda":
        return "gloo"
    resolve_device(None)        # raises without a card
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout: Optional[float] = None,
                         device=None) -> bool:
    """Form the default process group; returns whether it spans more than
    one rank.

    The coordinator is ``coordinator_address`` (``host:port`` or a URL) or,
    when the launcher set ``MASTER_ADDR``, ``env://``. Without either (and
    without ``num_processes``) this is a single-process run: nothing is
    done and the result is False. A group formed earlier in the process is
    kept. ``backend``: by default ``default_backend(device)``, where
    ``device`` is what the ranks run on (default ``cuda``). ``timeout``:
    seconds a collective, and the join itself, may wait. A group that
    fails to form raises; nothing falls back to a single process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "env://"
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError("num_processes given without a coordinator: pass "
                         "coordinator_address or set MASTER_ADDR")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend or default_backend(device),
                            init_method=_init_method(coordinator_address),
                            **kwargs)
    return dist.get_world_size() > 1


def shard_files_for_host(files: Sequence,
                         process_index: Optional[int] = None,
                         process_count: Optional[int] = None):
    """This rank's deterministic slice of the corpus file list: file ``i``
    goes to rank ``i % count``. Without a process group the defaults are
    rank 0 of 1 (every file)."""
    grouped = dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if grouped else 0
    if process_count is None:
        process_count = dist.get_world_size() if grouped else 1
    return [f for i, f in enumerate(files)
            if i % process_count == process_index]
