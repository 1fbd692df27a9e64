"""The process mesh: data-parallel and sequence-parallel training over ranks.

Counterpart of mst_tpu/parallel/mesh.py. JAX lays devices out on a
``Mesh`` and lets GSPMD insert the collectives; here one process runs per
rank and the collectives are written out:

- ``create_mesh`` lays the first ``n_data * n_seq`` ranks out as a
  (data, seq) grid, row-major as JAX reshapes ``devices[:n]``, and forms
  the process groups of this rank's data axis (the ranks that share its
  seq index), of its seq axis (the ranks that share its data index, and
  so its songs) and of the whole mesh;
- the batch axis is sharded over ``data``: each rank builds and holds only
  its own rows (``shard_batch``, or ``device_batch_from_songs(mesh=...)``,
  whose rasters K1 builds on the rank itself);
- the bar axis is sharded over ``seq``: each rank holds bars
  ``[s*R/n, (s+1)*R/n)`` of every raster and activation (``Mesh.seq_bars``);
  the per-song fields stay whole on every seq rank, and the model's
  bar-axis ops cross ranks under ``mst_torch.ops.seq_context``;
- parameters and optimizer state are replicated: ``replicate`` broadcasts
  them from the mesh's first rank;
- the step (``make_sharded_train_step``) all-reduces the loss's partial
  sums before their nonlinear combination (the per-cell ones over the
  whole mesh, the per-song ones over the data axis), so every rank
  computes the global batch's loss, and all-reduces each micro-step's
  parameter gradients over the whole mesh, as JAX's psum does inside the
  step.

Serving over a mesh needs no process group: one process drives the cards
of a ``DeviceMesh`` (``create_device_mesh``), as JAX's single controller
does, and ``mst_torch.transfer.ModelBundle(mesh=...)`` shards its batches
over the mesh's data axis.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from mst_torch.config import Config
from mst_torch.device import as_device, resolve_device
from mst_torch.runtime.train import make_train_step


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (data, seq) grid."""

    shape: dict                  # {"data": n_data, "seq": n_seq}
    data_index: int              # this rank's coordinates
    seq_index: int
    data_group: object           # the process groups of its data axis
    seq_group: object            # and of its seq axis
    device: torch.device
    group: object = None         # the process group of the whole mesh

    def data_rows(self, batch: int) -> slice:
        """This rank's rows ``r*B_loc:(r+1)*B_loc`` of a global batch of
        ``batch`` rows (r: its data index); raises unless the data axis
        divides the batch."""
        n = self.shape["data"]
        if batch % n:
            raise ValueError(f"batch {batch} not divisible by data={n}")
        return slice(self.data_index * (batch // n),
                     (self.data_index + 1) * (batch // n))

    def seq_bars(self, n_bars: int) -> slice:
        """This rank's bars ``s*R/n:(s+1)*R/n`` of a bar bucket of
        ``n_bars`` (s: its seq index); raises unless the seq axis divides
        the bucket."""
        n = self.shape["seq"]
        if n_bars % n:
            raise ValueError(f"bar bucket {n_bars} not divisible by "
                             f"--seq-parallel {n}")
        return slice(self.seq_index * (n_bars // n),
                     (self.seq_index + 1) * (n_bars // n))


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda`` (the default) means card ``LOCAL_RANK``
    modulo the cards present, so ranks that outnumber the cards share them;
    without a card that is an error. Anything else is taken as given. A
    card becomes the calling thread's current device, where the rank's
    collectives and the streams of its kernels live."""
    if device is None or str(device) == "cuda":
        resolve_device(None)
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices of one process along a data axis: shard i of a batch runs on
    ``devices[i]`` (mst_tpu's ``jax.sharding.Mesh`` over ``("data",
    "seq")`` with a seq axis of 1: serving shards rows alone)."""

    devices: tuple               # n_data torch.devices

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "seq": 1}


def create_device_mesh(n_data: Optional[int] = None,
                       devices=None) -> DeviceMesh:
    """A data axis over ``devices[:n_data]``, the counterpart of mst_tpu's
    ``create_mesh(n_data, n_seq=1)`` (mst_tpu/parallel/mesh.py:34-49) over
    ``jax.devices()``. ``devices``: default every visible card (without
    one that is an error, never a fall back to the CPU); a device may
    appear more than once (``["cpu"] * 4``, or two shards on one card).
    ``n_data`` None or negative: every device."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [as_device(d) for d in devices]
    if n_data is None or n_data < 0:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"a data axis of {n_data} does not fit "
                         f"{len(devices)} devices")
    return DeviceMesh(tuple(devices[:n_data]))


def create_mesh(n_data: Optional[int] = None, n_seq: int = 1,
                device=None) -> Mesh:
    """Lay the ranks of the default process group out as (data, seq).

    ``n_data`` None or negative: every rank not needed by ``n_seq`` goes
    on the data axis. Rank ``r < n_data * n_seq`` sits at
    ``(r // n_seq, r % n_seq)``. Every rank of the default group must call
    this (forming a group is collective). A rank beyond the grid raises
    after the groups are formed. ``device``: this rank's device
    (``local_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "mst_torch.parallel.initialize_multihost first")
    world = dist.get_world_size()
    if n_data is None or n_data < 0:
        n_data = world // n_seq
    if n_data < 1 or n_seq < 1 or n_data * n_seq > world:
        raise ValueError(f"mesh {n_data} x {n_seq} does not fit {world} "
                         f"ranks")
    data_axes = [tuple(i * n_seq + j for i in range(n_data))
                 for j in range(n_seq)]
    seq_axes = [tuple(i * n_seq + j for j in range(n_seq))
                for i in range(n_data)]
    # every rank forms every group, in the same order
    data_groups = [dist.new_group(list(r)) for r in data_axes]
    seq_groups = [dist.new_group(list(r)) for r in seq_axes]
    whole = dist.new_group(list(range(n_data * n_seq)))
    rank = dist.get_rank()
    if rank >= n_data * n_seq:
        raise ValueError(f"rank {rank} lies outside the {n_data} x {n_seq} "
                         f"mesh")
    i, j = divmod(rank, n_seq)
    return Mesh(shape={"data": n_data, "seq": n_seq}, data_index=i,
                seq_index=j, data_group=data_groups[j],
                seq_group=seq_groups[i], device=local_device(device),
                group=whole)


def shard_batch(batch, mesh: Mesh):
    """This rank's share of a global ``Batch``: its rows
    (``Mesh.data_rows``) of every field and, of the pitched and unpitched
    rasters, its bars (``Mesh.seq_bars``, dim 2)."""
    rows = mesh.data_rows(batch.mode.shape[0])
    bars = mesh.seq_bars(batch.pitched.shape[2])
    rasters = ("pitched", "unpitched")
    return type(batch)(*(
        None if x is None else x[rows, :, bars] if name in rasters
        else x[rows] for name, x in zip(batch._fields, batch)))


def _state_tensors(module_or_state):
    """The tensors ``replicate`` broadcasts, in one order on every rank:
    parameters and buffers, then (for a TrainState) the accumulated
    gradients and the optimizer state."""
    module = getattr(module_or_state, "model", module_or_state)
    tensors = list(module.parameters()) + list(module.buffers())
    optimizer = getattr(module_or_state, "optimizer", None)
    if optimizer is not None:
        tensors += [p.grad for p in module.parameters()
                    if p.grad is not None]
        for p in module.parameters():
            state = optimizer.state.get(p, {})
            tensors += [state[k] for k in sorted(state)
                        if torch.is_tensor(state[k])]
    return tensors


@torch.no_grad()
def replicate(module_or_state, mesh: Mesh):
    """Broadcast a module's parameters (and, for a TrainState, its
    accumulated gradients and optimizer state) from the mesh's first rank
    to all of its ranks, in place. Every rank must hold a state of the
    same structure. Returns its argument."""
    for t in _state_tensors(module_or_state):
        buf = t.to(mesh.device)
        dist.broadcast(buf, src=0, group=mesh.group)
        if buf is not t:
            t.copy_(buf)
    return module_or_state


def make_sharded_train_step(config: Config, has_unpitched: bool,
                            mesh: Mesh):
    """The micro-step on this rank's rows and bars of the global batch: the
    losses of the global batch, gradients summed over the mesh, the same
    Adam update on every rank. It is
    ``mst_torch.runtime.train.make_train_step(..., mesh=mesh)``, run
    eagerly (a step over a mesh is not captured), and exists only so that
    mst_tpu.parallel.mesh's API carries over."""
    return make_train_step(config, has_unpitched, mesh=mesh, capture=False)
