"""Process groups and device meshes: one process is one rank, and on the
card one rank is one GPU.

Counterpart of ``metalhuffman_tpu/parallel/mesh.py``: a 1-D ``("seq",)``
mesh for block-range decode and encode, a 2-D ``("data", "seq")`` mesh for
frames x block ranges, and the set-up of the process group. The collective
backend follows the device the tensors lie on: NCCL for CUDA, gloo for the
CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"  # frames (batch) axis
SEQ_AXIS = "seq"  # block-range (sequence-parallel) axis
#: the collective backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device) -> str:
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no collective backend for tensors on {device}")
    return BACKENDS[kind]


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device="cuda") -> None:
    """Join the process group as ``rank`` of ``world_size``, with the backend
    of ``device`` (``init_method``: for instance ``"tcp://127.0.0.1:29500"``).

    A CUDA rank first makes its GPU current: the index of ``device`` when it
    names one, else its local rank (:func:`local_rank`).
    """
    backend = _backend(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank(rank) if dev.index is None
                              else dev.index)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def local_rank(rank: int) -> int:
    """This process's GPU on its host: ``LOCAL_RANK`` when the launcher sets
    it (``torchrun`` does), else ``rank`` modulo the host's GPUs, which
    holds when every host runs one rank per GPU in rank order."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def process_info() -> tuple[int, int]:
    """(rank, world size) — (0, 1) when no process group is initialized."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def default_data_parallel(n: int) -> int:
    """The largest power of two that divides ``n`` and is <= sqrt(n)."""
    data_parallel = 1
    while data_parallel * 2 <= max(1, int(n**0.5)) and n % (data_parallel * 2) == 0:
        data_parallel *= 2
    return data_parallel


def _ranks(n_devices: int | None) -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    return dist.get_world_size() if n_devices is None else n_devices


def make_mesh(n_devices: int | None = None, axis_name: str = SEQ_AXIS, *,
              device="cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default)."""
    n = _ranks(n_devices)
    return DeviceMesh(torch.device(device).type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def make_mesh_2d(n_devices: int | None = None,
                 data_parallel: int | None = None, *,
                 device="cuda") -> DeviceMesh:
    """2-D ``data x seq`` mesh: frames over ``data``, block ranges over
    ``seq``. ``data_parallel`` defaults to :func:`default_data_parallel`."""
    n = _ranks(n_devices)
    if data_parallel is None:
        data_parallel = default_data_parallel(n)
    if n % data_parallel:
        raise ValueError(f"data_parallel={data_parallel} does not divide {n} devices")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).view(data_parallel, n // data_parallel),
                      mesh_dim_names=(DATA_AXIS, SEQ_AXIS))


def axis_coords(mesh: DeviceMesh | None):
    """This rank's (index, size, group) along the block-range axis of
    ``mesh``: the only axis of a 1-D mesh (whatever :func:`make_mesh` named
    it), else ``SEQ_AXIS``. With no mesh, along every rank of the default
    group (group None)."""
    if mesh is None:
        return dist.get_rank(), dist.get_world_size(), None
    names = mesh.mesh_dim_names
    axis = names[0] if len(names) == 1 else SEQ_AXIS
    return (mesh.get_local_rank(axis), mesh.size(names.index(axis)),
            mesh.get_group(axis))


def grid_layout(mesh: DeviceMesh | None):
    """This rank's ((data index, data size), (seq index, seq size)) and the
    (data, seq) grid of ranks, as nested lists. ``mesh`` must hold every
    rank of the default group, which the grid's gather runs over; with no
    mesh, the grid of :func:`make_mesh_2d`'s default."""
    world = dist.get_world_size()
    if mesh is None:
        layout = torch.arange(world).view(default_data_parallel(world), -1)
    else:
        names = mesh.mesh_dim_names
        layout = mesh.mesh.permute(names.index(DATA_AXIS),
                                   names.index(SEQ_AXIS))
    if layout.numel() != world:
        raise ValueError(f"the mesh holds {layout.numel()} of {world} ranks; "
                         "a grid gather needs all of them")
    d, s = (layout == dist.get_rank()).nonzero()[0].tolist()
    return (d, layout.shape[0]), (s, layout.shape[1]), layout.tolist()
