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

The mesh-aware model path adds `MeshShape` (a production mesh's axis names
and sizes without its ranks, for the spec rules of `launch.sharding`),
`shmap` (the reference's `shard_map` over `local_map`, with the port's
specs) and `axis_groups` (the process groups of sub-rings and de-dup groups
along one axis, or of several axes together).
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

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


_fake_meshes: Dict[bool, object] = {}


def fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh of a fake world, for the dry run
    (`launch.dryrun`): rank 0 of a world of 256 (or 512) ranks, opened on
    PyTorch's fake process group (``cpu:fake,meta:fake``, a `FakeStore`:
    collectives complete at once and move nothing), with a CPU
    `DeviceMesh` of shape (16, 16) ("data", "model") or (2, 16, 16)
    ("pod", "data", "model").  Tensors on it are meta tensors: no card and
    no memory are needed.

    A process holds one default group, so moving between the single-pod
    and the multi-pod world destroys the fake group and opens the other;
    an open group that is not this fake world raises.  While the fake
    world is open, DTensor's shard-to-shard redistribution runs its
    all-to-all (as on NCCL) instead of the all-gather + chunk it uses on
    CPU meshes for gloo, which has no all-to-all."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    if dist.is_initialized():
        if not _fake_meshes:
            raise RuntimeError("a process group that is not the dry run's "
                               "fake world is open")
        if dist.get_world_size() != world:
            close_fake_world()
    if not dist.is_initialized():
        dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                                rank=0, world_size=world)
        _alltoall_as_on_nccl(True)
    if multi_pod not in _fake_meshes:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod",) + AXES if multi_pod else AXES
        _fake_meshes[multi_pod] = init_device_mesh("cpu", shape,
                                                   mesh_dim_names=axes)
    return _fake_meshes[multi_pod]


def close_fake_world() -> None:
    """Destroy the dry run's fake world, if it is open."""
    if _fake_meshes and dist.is_initialized():
        dist.destroy_process_group()
    _fake_meshes.clear()
    _alltoall_as_on_nccl(False)


_cpu_alltoall = None


def _alltoall_as_on_nccl(on: bool) -> None:
    global _cpu_alltoall
    from torch.distributed.tensor import placement_types as pt

    if on and _cpu_alltoall is None:
        import torch.distributed._functional_collectives as funcol

        _cpu_alltoall = pt.shard_dim_alltoall

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            group = funcol._resolve_group((mesh, mesh_dim))
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                funcol._group_or_group_name(group))

        pt.shard_dim_alltoall = alltoall
    elif not on and _cpu_alltoall is not None:
        pt.shard_dim_alltoall, _cpu_alltoall = _cpu_alltoall, None


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


class MeshShape:
    """Axis names and sizes of a mesh without its ranks: the (16, 16) and
    (2, 16, 16) production meshes for the spec rules of `launch.sharding`,
    which never need a process per rank."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        assert len(shape) == len(axis_names), (shape, axis_names)
        self.mesh_dim_names = tuple(axis_names)
        self.axis_names = self.mesh_dim_names
        self.shape: Dict[str, int] = dict(zip(axis_names, map(int, shape)))

    @property
    def ndim(self) -> int:
        return len(self.mesh_dim_names)

    def size(self, dim: Optional[int] = None) -> int:
        if dim is None:
            n = 1
            for v in self.shape.values():
                n *= v
            return n
        return self.shape[self.mesh_dim_names[dim]]

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production meshes' shapes: (16, 16) ("data", "model"), or
    (2, 16, 16) with a leading "pod" axis."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod",) + AXES)
    return MeshShape((16, 16), AXES)


def axis_groups(mesh, axes: Sequence[str], block: Optional[int] = None):
    """The process group of this rank along ``axes`` of ``mesh`` (one axis,
    or several taken together in mesh order: group rank = the row-major
    index over them), optionally cut into consecutive blocks of ``block``
    coordinates along a single axis (the DoP sub-rings of
    `striped.ring_pairs(n, dop)`, A2's de-dup groups).

    Collective: every rank of the world must call it with the same
    arguments in the same order.  A whole single axis reuses the mesh's own
    group; the others are created once per mesh and cached on it."""
    names = list(mesh.mesh_dim_names)
    axes = tuple(axes)
    if len(axes) == 1 and block in (None, axis_size(mesh, axes[0])):
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    key = (axes, block)
    if key not in cache:
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), (axes, names)
        rest = [i for i in range(len(names)) if i not in idx]
        grid = mesh.mesh.permute(*rest, *idx)
        n_rest = 1
        for i in rest:
            n_rest *= int(mesh.mesh.shape[i])
        rows = grid.reshape(n_rest, -1).tolist()
        groups: List[List[int]] = []
        for row in rows:
            if block is None:
                groups.append(row)
            else:
                assert len(axes) == 1 and len(row) % block == 0, (axes, block)
                groups += [row[b:b + block] for b in range(0, len(row), block)]
        cache[key], _ = dist.new_subgroups_by_enumeration(groups)
    return cache[key]


def _spec_placements(mesh, spec, ndim):
    from repro_torch.launch.sharding import placements

    return tuple(placements(mesh, spec, ndim))


def _spec_leaves(specs):
    """Flatten a tree of specs (tuples / NamedTuples of `sharding.P`, a `P`
    being a leaf) in order."""
    from repro_torch.launch.sharding import P

    if isinstance(specs, P) or specs is None:
        return [specs]
    return [s for sub in specs for s in _spec_leaves(sub)]


def shmap(body, mesh, in_specs, out_specs, *, in_grad_specs=None):
    """The reference's ``shard_map(body, mesh, in_specs, out_specs)`` over
    `torch.distributed.tensor.experimental.local_map`.

    ``in_specs`` has one `sharding.P` per positional argument (applied to
    every tensor leaf of a dict argument, as a JAX spec prefix; None for a
    non-tensor); a DTensor argument is redistributed to it, a plain tensor
    is taken as the replicated global value.  ``out_specs`` is one `P` or a
    (nested) tuple of them, each written out to its output's full rank.
    ``in_grad_specs`` (one entry per argument: None keeps the input's
    placements, else a tuple of DTensor placements) names the placements
    of an input's gradient where they differ from its own: a replicated
    operand each rank uses only a part of has a partial gradient.  The body sees local
    tensors and runs its collectives itself; the call is differentiable."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    out_pl = tuple(_spec_placements(mesh, s, len(s))
                   for s in _spec_leaves(out_specs))

    def run(*args):
        flat_in, in_pl, grad_pl = [], [], []
        for i, (a, spec) in enumerate(zip(args, in_specs)):
            gspec = in_grad_specs[i] if in_grad_specs is not None else None
            leaves, tspec = pytree.tree_flatten(a)
            new = []
            for leaf in leaves:
                if spec is None or not isinstance(leaf, torch.Tensor):
                    new.append(leaf)
                    in_pl.append(None)
                    grad_pl.append(None)
                    continue
                if not isinstance(leaf, DTensor):
                    leaf = DTensor.from_local(
                        leaf, mesh, [Replicate()] * mesh.ndim, run_check=False)
                new.append(leaf)
                pl = _spec_placements(mesh, spec, leaf.ndim)
                in_pl.append(pl)
                grad_pl.append(pl if gspec is None else tuple(gspec))
            flat_in.append(pytree.tree_unflatten(new, tspec))
        fn = local_map(
            body, out_placements=out_pl, in_placements=tuple(in_pl),
            in_grad_placements=tuple(grad_pl), device_mesh=mesh,
            redistribute_inputs=True,
        )
        return fn(*flat_in)

    return run
