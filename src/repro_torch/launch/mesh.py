"""Mesh construction on `torch.distributed` (the port of
`repro/launch/mesh.py`).

Single pod: (16, 16) = ("data", "model") — 256 ranks.  ``data`` is the ESP
sequence-parallel axis between elastic instances; ``model`` is intra-instance
tensor parallelism (DESIGN.md §3).  Multi-pod: (2, 16, 16) = ("pod", "data",
"model").

The reference builds a `jax.make_mesh` over the devices of one process.  Here
every rank is a process of its own: `init_process_group` opens the world (NCCL
on ``cuda``, gloo on ``cpu``) and the meshes are `init_device_mesh` grids of
ranks over it.  `SubMesh` is the port's counterpart of the reference's
sub-meshes (an ESP group over a subset of the "data" coordinates): a process
group per "model" column, created collectively by every rank of the world.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device="cuda", *, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       timeout_s: float = 600.0) -> str:
    """Open the default process group for ``device``'s backend and return
    the backend's name.  ``cuda`` opens NCCL and raises where there is no
    CUDA device; ``cpu`` opens gloo.  Nothing falls back to another backend.

    ``world_size`` / ``rank`` default to the ``WORLD_SIZE`` / ``RANK``
    environment (1 / 0 without it); ``init_method`` to ``env://`` when
    ``MASTER_ADDR`` is set, else a free ``tcp://127.0.0.1`` port (one-rank
    worlds only).  An already-open group must have the same backend."""
    dev = torch.device(device)
    backend = backend_for(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; NCCL needs one (pass device='cpu' for gloo)"
        )
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"the open process group runs {have}, not {backend} "
                f"(device {dev})"
            )
        return backend
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise ValueError(
                "a world of more than one rank needs init_method= or the "
                "MASTER_ADDR / MASTER_PORT environment"
            )
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return backend


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod",) + AXES if multi_pod else AXES
    return _device_mesh(device, shape, axes)


def make_test_mesh(data: int = 4, model: int = 2, pod: int = 0, *,
                   device="cuda"):
    """Small mesh over the open world (``data * model`` ranks; ``pod``
    adds a leading replica axis)."""
    if pod:
        return _device_mesh(device, (pod, data, model), ("pod",) + AXES)
    return _device_mesh(device, (data, model), AXES)


def _device_mesh(device, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    init_process_group(device)
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


class SubMesh:
    """The ranks of a subset of a mesh's "data" coordinates (an elastic ESP
    group) and, for each "model" column, the process group along "data".

    ``coords`` are sorted data coordinates; group rank i of every column is
    coordinate ``coords[i]``.  Construction is collective: every rank of the
    world must build the same SubMeshes in the same order
    (`dist.new_subgroups_by_enumeration`), ranks outside the group too —
    for them ``group`` and ``rank`` are None.  A SubMesh over every data
    coordinate reuses the mesh's own "data" groups."""

    def __init__(self, mesh, coords: Sequence[int]):
        grid = mesh.mesh
        names = list(mesh.mesh_dim_names)
        grid = grid.permute(names.index("data"), names.index("model"))
        self.coords: Tuple[int, ...] = tuple(sorted(int(c) for c in coords))
        cols: List[List[int]] = [
            [int(grid[c, m]) for c in self.coords]
            for m in range(grid.shape[1])
        ]
        me = dist.get_rank()
        if list(self.coords) == list(range(grid.shape[0])):
            self.group = mesh.get_group("data")
        else:
            self.group, _ = dist.new_subgroups_by_enumeration(cols)
        self.rank: Optional[int] = None
        for col in cols:
            if me in col:
                self.rank = col.index(me)
        if self.rank is None:
            self.group = None
        self.n = len(self.coords)
        self.shape = {"data": self.n, "model": len(cols)}
        self.ranks = frozenset(r for col in cols for r in col)
        self.leader = cols[0][0]  # the broadcast source of group results

    def __repr__(self) -> str:
        return f"SubMesh(coords={self.coords}, model={self.shape['model']})"


def axis_size(mesh, axis: str = "data") -> int:
    if isinstance(mesh, SubMesh):
        return mesh.shape[axis]
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_info(mesh, axis: str = "data"):
    """(size, this rank's coordinate, process group) of ``mesh``'s ``axis``
    — for a `torch.distributed.device_mesh.DeviceMesh` or a `SubMesh`."""
    if isinstance(mesh, SubMesh):
        assert axis == "data", axis
        return mesh.n, mesh.rank, mesh.group
    return (axis_size(mesh, axis), int(mesh.get_local_rank(axis)),
            mesh.get_group(axis))


def data_coordinate(mesh) -> int:
    """This rank's coordinate on the mesh's "data" axis."""
    return int(mesh.get_local_rank("data"))


def rank_of(mesh, data: int, model: int = 0) -> int:
    """Global rank at (data, model) of a ("data", "model") mesh."""
    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh.permute(names.index("data"), names.index("model"))
    return int(grid[data, model])
