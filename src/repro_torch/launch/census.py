"""Per-rank op census of a step: FLOPs, bytes and collective traffic.

The PyTorch counterpart of `repro/launch/hlo.py` (`hlo_census`,
`collective_census`).  The reference parses one compiled HLO program, the
same for every device.  The port has no such program: a step is eager ops,
so `Census` is a `TorchDispatchMode` that watches the ops a step runs on
this process and sums, for this rank (rank 0 of a fake world in the dry
run):

  * FLOPs: `torch.utils.flop_counter`'s formulas for the products (mm, bmm,
    addmm, baddbmm, convolutions, SDPA), as the reference counts dot FLOPs
    only; elementwise FLOPs are excluded;
  * bytes: operand + output bytes of each op that is not a view or a bare
    allocation — an HBM-traffic proxy, as `hlo.py`'s operand + output bytes
    per fusion are (eager ops materialize every output, so this is the
    unfused upper bound of the same proxy);
  * collectives: per-rank traffic per op class, scaled as `hlo.py:191-198`
    scales it — all-reduce 2(g-1)/g x payload; all-gather, reduce-scatter
    and all-to-all (g-1)/g x payload (the gathered output, the scattered
    input); a permute its payload.  DTensor's redistributions arrive as
    ``_c10d_functional`` ops (and ``_dtensor.shard_dim_alltoall``); the port's own counted collectives
    (`kernels.ops`: ring_ppermute, ppermute, psum, pmax, psum_scatter,
    all_gather, broadcast) report through `report_collective`, with the
    same payloads they add to `ops.comm_bytes`.

Only local (plain-tensor) ops count.  An op on DTensors is handed on to
DTensor (the mode returns NotImplemented), whose local redispatch then
comes back here with rank 0's shards; the fake tensors of DTensor's
sharding propagation (global shapes) are never counted.  So a DTensor
product counts once, at its per-rank size.

The kernels are counted by shape (`report_kernel`): each wrapper (K1-K5
and K4's backward) reports its FLOPs and bytes from its operands' shapes
and mask flags, never from their data, so meta, CPU and CUDA tensors give
the same number with no host sync.  Whatever a wrapper runs to do its work
(the plain version on the CPU, the launch's preparation on the card,
empty outputs on meta) runs `uncounted()`, so a kernel is never counted
twice.  FLOPs of an attention kernel are ``4 H D`` per (query, key) pair
the mask can keep, from shapes: ``B Sq Sk``, halved when causal, with Sk
capped at the window (`attention_pairs`); the backward does five products
per pair where the forward does two, ``10 H D`` per pair.  Bytes are each
operand read once and each output written once: what the reference's
``kernel_adjusted`` census assumed of a Pallas kernel is, in the port,
always so.

`scope(name)` is the counterpart of a ``jax.named_scope``; ``exclude_scope``
drops the bytes (not the FLOPs or collectives) of ops run inside any scope
whose name contains one of its comma-separated entries, as `hlo_census`'s
option does.  The scopes are where the reference's are:
``esp_partial_attention`` (`models.attention.partial_attention`),
``mlstm_chunk_body`` and ``slstm_step_body`` (`models.xlstm`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_active: List["Census"] = []  # innermost last
_uncounted = 0
_scopes: List[str] = []


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """A named scope for ``exclude_scope`` (a ``jax.named_scope``)."""
    _scopes.append(name)
    try:
        yield
    finally:
        _scopes.pop()


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Ops run inside are not counted: a kernel's own work, reported by
    shape."""
    global _uncounted
    _uncounted += 1
    try:
        yield
    finally:
        _uncounted -= 1


def active() -> bool:
    return bool(_active) and not _uncounted


def nbytes(*tensors) -> int:
    """Bytes of tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def attention_pairs(b: int, sq: int, sk: int, *, causal: bool,
                    window: Optional[int]) -> float:
    """(query, key) pairs an attention kernel's mask can keep, from shapes:
    ``b sq min(sk, window)``, halved when causal."""
    kk = sk if window is None else min(sk, int(window))
    return b * sq * kk * (0.5 if causal else 1.0)


def attention_flops(b: int, sq: int, sk: int, h: int, d: int, *,
                    causal: bool, window: Optional[int],
                    backward: bool = False) -> float:
    """A flash kernel's product FLOPs: ``4 h d`` per kept pair forward (QK^T
    and PV), ``10 h d`` backward (QK^T again, dP, dV, dQ, dK)."""
    per_pair = (10 if backward else 4) * h * d
    return per_pair * attention_pairs(b, sq, sk, causal=causal, window=window)


def report_kernel(name: str, flops: float, bytes_: float) -> None:
    """One kernel call's work, into every active census (a call made while
    another kernel's work runs uncounted is part of that kernel's)."""
    if not active():
        return
    for c in _active:
        c._kernel(name, flops, bytes_)


def report_collective(kind: str, payload: float, group_size: int) -> None:
    """One of the port's counted collectives (`kernels.ops`): ``kind`` its
    class in `COLLECTIVES`, ``payload`` the bytes it adds to
    ``ops.comm_bytes`` (for an all-gather the local slice, for the others
    the operand; a broadcast counts as a permute of its payload)."""
    if not active():
        return
    g = max(int(group_size), 1)
    if kind == "all-reduce":
        b = 2 * (g - 1) / g * payload
    elif kind == "all-gather":  # the gathered output is g slices
        b = (g - 1) * payload
    elif kind in ("reduce-scatter", "all-to-all"):
        b = (g - 1) / g * payload
    else:
        b = float(payload)
    for c in _active:
        c.coll[kind] += b


# ops that move no data (views are excluded by `OpOverload.is_view`;
# ``_unsafe_view`` is a view of a fresh tensor that the schema does not mark)
_NO_BYTES = {
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::lift_fresh", "aten::alias", "aten::_unsafe_view",
    "aten::_local_scalar_dense",
    "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def _funcol(func, args) -> Optional[tuple]:
    """(class, per-rank bytes) of a ``_c10d_functional`` collective (the
    ones DTensor's redistributions emit)."""
    name = func._schema.name.split("::", 1)[1].rstrip("_")
    ins = nbytes(args[0])
    if name == "all_reduce":
        g = _group_size(args[-1])
        return "all-reduce", 2 * (g - 1) / g * ins
    if name == "all_gather_into_tensor":
        g = int(args[1])
        return "all-gather", (g - 1) / g * (g * ins)
    if name == "reduce_scatter_tensor":
        g = int(args[2])
        return "reduce-scatter", (g - 1) / g * ins
    if name == "all_to_all_single":
        g = _group_size(args[-1])
        return "all-to-all", (g - 1) / g * ins
    return None


class Census(TorchDispatchMode):
    """Counts the ops run inside ``with Census() as c:``; `result()` is
    the per-rank count with `hlo_census`'s keys (plus ``kernels``).

    ``exclude_scope``: comma-separated scope names whose ops' bytes are
    dropped (FLOPs and collectives still count)."""

    def __init__(self, exclude_scope: Optional[str] = None):
        super().__init__()
        self.exclude = [s for s in (exclude_scope or "").split(",") if s]
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.kernels: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _active.remove(self)

    def _kernel(self, name, flops, bytes_):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(bytes_)
        self.flops += float(flops)
        self.bytes += float(bytes_)

    def _excluded(self) -> bool:
        return any(sc in s for s in _scopes for sc in self.exclude)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # counted at its local redispatch
        out = func(*args, **kwargs)
        if _uncounted:
            return out
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [a for a in pytree.tree_leaves(out) if isinstance(a, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's sharding propagation, global shapes
        name = func._schema.name
        if name.startswith("_c10d_functional::"):
            got = _funcol(func, args)
            if got is not None:
                self.coll[got[0]] += got[1]
        elif name == "_dtensor::shard_dim_alltoall":
            g = _group_size(args[3])
            self.coll["all-to-all"] += (g - 1) / g * nbytes(args[0])
        from torch.utils.flop_counter import flop_registry

        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        if (func.is_view or name in _NO_BYTES or name.startswith("c10d::")
                or (self.exclude and self._excluded())):
            return out
        self.bytes += nbytes(*ins) + nbytes(*outs)
        return out

    def result(self) -> Dict[str, object]:
        """``flops``, ``bytes``, one entry per collective class,
        ``collective_bytes`` (their sum) and ``kernels`` ({name: calls,
        flops, bytes})."""
        out: Dict[str, object] = {"flops": self.flops, "bytes": self.bytes}
        out.update(self.coll)
        out["collective_bytes"] = sum(self.coll.values())
        out["kernels"] = {k: dict(v) for k, v in sorted(self.kernels.items())}
        return out


def collective_census(census: "Census") -> Dict[str, float]:
    """`hlo.collective_census`'s keys from a finished census: one entry per
    collective class, ``total_bytes``, ``flops`` and ``bytes``."""
    r = census.result()
    out = {k: r[k] for k in COLLECTIVES}
    out["total_bytes"] = r["collective_bytes"]
    out["flops"] = r["flops"]
    out["bytes"] = r["bytes"]
    return out
