"""Process groups, the port's meshes and the collectives the parallel layer
uses.

The JAX package is a single controller: one process drives every device
of a ``jax.sharding.Mesh``. The port runs PyTorch's multi-process SPMD
instead: one process (rank) per card, every rank running the same program
on the same inputs, the work split by rank, and the reference's ``psum`` /
``all_gather`` becoming ``torch.distributed`` collectives over the process
group of a named mesh axis.

``initialize_from_env`` brings the group up from the reference's own
variables: ``EAO_COORDINATOR`` (``host:port``, or an init URL such as
``tcp://host:port`` or ``file:///path``), ``EAO_NUM_PROCESSES`` and
``EAO_PROCESS_ID``. A rank runs on ``cuda:<local rank>`` (the local rank is
``EAO_LOCAL_RANK``, else the process id modulo the cards of the host;
ranks share a card when there are fewer cards than ranks) unless the
caller asks for the CPU, with NCCL on a card and gloo on the CPU unless
``backend=`` says otherwise. Two ranks on one card need ``backend="gloo"``:
NCCL takes one rank per card.

A ``Mesh`` is the ranks of the world laid out on named axes, with the
process group of every set of axes. Every collective is an ``all_reduce``
(sum), so one code path serves both backends (gloo takes CUDA tensors only
for ``all_reduce``, ``broadcast`` and ``barrier``): an all-gather is a sum
into a zeroed buffer in which each rank fills its own slot, over the
integer bits of the values, so the gathered values are the ranks' own bit
for bit. Without a process group a mesh has one rank and every collective
is the identity.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
import zlib
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

HOST_AXIS = "host"
DEV_AXIS = "device"

Axes = Union[str, Sequence[str], None]


def world() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_cuda_device(pid: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "rank on the CPU")
    local = os.environ.get("EAO_LOCAL_RANK")
    local = int(local) if local is not None else pid
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_from_env(backend: Optional[str] = None, device=None,
                        timeout_s: float = 600.0) -> bool:
    """Join the process group the ``EAO_*`` variables name. Returns False
    when ``EAO_COORDINATOR`` is unset (one process, no group), True once
    the group is up (also on a second call). Raises when the variables are
    inconsistent or the group cannot form within ``timeout_s``."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("EAO_COORDINATOR")
    if not coord:
        return False
    n_proc = int(os.environ.get("EAO_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("EAO_PROCESS_ID", "0"))
    if not 0 <= pid < n_proc:
        raise ValueError(f"EAO_PROCESS_ID={pid} is outside EAO_NUM_PROCESSES={n_proc}")
    dev = torch.device(device) if device is not None else _local_cuda_device(pid)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=url, world_size=n_proc, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device() -> torch.device:
    """The card this rank runs on (the one ``initialize_from_env`` made
    current). A rank on the CPU passes ``device="cpu"`` to the meshes and
    entry points instead."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the port "
                           "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Mesh:
    """The ranks of the world on named axes (``ranks`` has one dimension
    per axis), the device this rank computes on and the process group of
    every set of axes. Building one is collective: every rank of the world
    builds the same meshes in the same order."""

    def __init__(self, ranks, axis_names: Sequence[str], device=None):
        self.ranks = np.asarray(ranks, np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.shape} ranks for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.device = torch.device(device) if device is not None else rank_device()
        rank, n_world = world()
        if sorted(self.ranks.ravel().tolist()) != list(range(n_world)):
            raise ValueError(f"a mesh spans every rank of the world ({n_world}), "
                             f"got {self.ranks.ravel().tolist()}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(self.ranks == rank)[0])))
        self._groups = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(range(len(self.axis_names)), k):
                self._groups[tuple(self.axis_names[a] for a in axes)] = self._make_group(axes)

    def _make_group(self, axes):
        """The group of the ranks that share this rank's coordinates on the
        other axes; every rank creates every such group in the same order."""
        rest = [a for a in range(self.ranks.ndim) if a not in axes]
        moved = np.transpose(self.ranks, rest + list(axes))
        blocks = moved.reshape(-1, int(np.prod([self.ranks.shape[a] for a in axes])))
        _, n_world = world()
        mine = None
        for block in blocks:
            members = [int(r) for r in block]
            if len(members) == n_world:
                group = dist.group.WORLD if dist.is_initialized() else None
            elif len(members) == 1:
                group = None
            else:
                group = dist.new_group(members)
            if self.rank in members:
                mine = group
        return mine

    def _key(self, axes: Axes) -> tuple:
        if axes is None:
            return self.axis_names
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in key)

    def axis_size(self, axes: Axes = None) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axes)]))

    def axis_index(self, axes: Axes = None) -> int:
        """This rank's position along the axes (row-major in mesh order)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes = None):
        """The process group over the axes, or None where the sum over them
        is the identity (one rank and no process group to call)."""
        return self._groups[self._key(axes)]


def psum(x: torch.Tensor, mesh: Mesh, axes: Axes = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks along the axes (a new tensor)."""
    group = mesh.group(axes)
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(y, group=group)
    return y


# integer types of each width that both backends sum (neither takes int16)
_BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes = None) -> torch.Tensor:
    """Every rank's ``x`` along the axes, concatenated on dim 0 in axis
    order (the reference's tiled ``all_gather``), bit for bit."""
    return all_gather_blocks(x, mesh, axes, [x.shape[0]] * mesh.axis_size(axes))


def all_gather_blocks(x: torch.Tensor, mesh: Mesh, axes: Axes,
                      counts: Sequence[int]) -> torch.Tensor:
    """As ``all_gather`` where rank i along the axes holds ``counts[i]``
    rows (blocks of unequal length)."""
    n = mesh.axis_size(axes)
    i = mesh.axis_index(axes)
    if len(counts) != n or x.shape[0] != counts[i]:
        raise ValueError(f"rank {i} of {n} holds {x.shape[0]} rows, counts {list(counts)}")
    if x.dtype == torch.bool:
        return all_gather_blocks(x.to(torch.uint8), mesh, axes, counts).to(torch.bool)
    bits = _BITS[x.element_size()]
    buf = torch.zeros((int(sum(counts)),) + tuple(x.shape[1:]), dtype=bits, device=x.device)
    lo = int(sum(counts[:i]))
    buf[lo:lo + x.shape[0]] = x.contiguous().view(bits)
    if mesh.group(axes) is not None:
        dist.all_reduce(buf, group=mesh.group(axes))
    return buf.view(x.dtype)


def block_range(n: int, parts: int, index: int) -> tuple:
    """[lo, hi) of block ``index`` when n items split into ``parts``
    contiguous blocks whose lengths differ by at most one (the longer
    first)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def _host_ids(n_world: int) -> list:
    """Each rank's host, as a hash of its host name, gathered."""
    rank, _ = world()
    mine = torch.zeros(n_world, dtype=torch.int64)
    mine[rank] = zlib.crc32(socket.gethostname().encode())
    if n_world > 1:
        dev = rank_device() if dist.get_backend() == "nccl" else torch.device("cpu")
        mine = mine.to(dev)
        dist.all_reduce(mine)
    return mine.cpu().tolist()


def global_mesh(n_virtual_hosts: Optional[int] = None, device=None) -> Mesh:
    """The global (host, device) mesh over every rank. Ranks on several
    hosts: the host axis is the hosts and the device axis the ranks of
    each host (ranks grouped by host). One host: its ranks folded into
    ``n_virtual_hosts`` virtual hosts (2 at 4 or more ranks, else 1), as
    the reference folds its local devices."""
    _, n_world = world()
    hosts = _host_ids(n_world)
    by_host = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    if len(by_host) > 1:
        rows = [by_host[h] for h in sorted(by_host, key=lambda h: by_host[h][0])]
        if len({len(r) for r in rows}) > 1:
            raise ValueError(f"hosts hold unequal numbers of ranks: {rows}")
        return Mesh(np.asarray(rows), (HOST_AXIS, DEV_AXIS), device)
    if n_virtual_hosts is None:
        n_virtual_hosts = 2 if n_world >= 4 else 1
    if n_world % n_virtual_hosts:
        raise ValueError(f"{n_world} ranks do not fold into {n_virtual_hosts} hosts")
    return Mesh(np.arange(n_world).reshape(n_virtual_hosts, -1), (HOST_AXIS, DEV_AXIS), device)


def line_mesh(axis: str, device=None) -> Mesh:
    """A one-axis mesh over every rank in rank order."""
    _, n_world = world()
    return Mesh(np.arange(n_world), (axis,), device)
