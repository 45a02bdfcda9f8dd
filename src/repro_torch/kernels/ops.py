"""Dispatch entry points for the port's kernels.

The tensor's device decides what runs: a CPU tensor goes to the kernel's
plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel (or the
wrapper raises).  There is no implementation switch and no fallback.

`dispatch_counts` tracks dispatch volume per entry point so tests and
`chip_smoke.py` can assert launch-count invariants (one paged decode launch
per instance per layer, zero serial prefills; one `attention` per attention
layer of a serial prefill, one `decode_partial` per attention layer of a
serial decode step).  The fault hook is the seam the engine's bounded-retry
path (and a chaos harness) injects `TransientDispatchError` through.

`attention_partial` is K4 as an unnormalized partial (the ESP ring step's
function).  The counted collectives (`ring_ppermute`, `ppermute`,
`psum`, `pmax`, `psum_scatter`, `all_gather`, `broadcast`) are the mesh
executor's and the mesh-aware model path's communication on
`torch.distributed` — gloo for CPU tensors, NCCL for CUDA tensors: each adds
one to `dispatch_counts` and the per-rank payload bytes to `comm_bytes`
under its name, as the reference's `lax` collectives do, and reports the
same payload with its group's size to the op census (`launch.census`).
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_decode import flash_decode_partial
from repro_torch.kernels.paged_flash_decode import paged_flash_decode_partial
from repro_torch.kernels.paged_flash_prefill import (
    packed_flash_prefill,
    packed_flash_prefill_ring_chunk,
)
from repro_torch.kernels.striped_attention import (
    striped_flash_attention,
    striped_flash_attention_lse,
)
from repro_torch.launch import census
from repro_torch.models.attention import Partial, empty_partial


class TransientDispatchError(RuntimeError):
    """A kernel dispatch failed transiently (injected by a chaos harness or
    raised by a flaky backend).  The engine retries with bounded backoff
    before declaring the instance failed — see engine/server.py."""


# Fault-injection seam: when set, every dispatch entry point (and the
# executors' per-batch dispatch guards) calls the hook with a point name
# BEFORE doing any work; the hook may raise TransientDispatchError.  Raising
# happens before any compute or KV write, so a retried dispatch is
# side-effect free.
_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or clear, with None) the dispatch fault hook."""
    global _fault_hook
    _fault_hook = hook


def check_fault(point: str) -> None:
    if _fault_hook is not None:
        _fault_hook(point)


dispatch_counts: Counter = Counter()
comm_bytes: Counter = Counter()


def reset_dispatch_counts() -> None:
    dispatch_counts.clear()
    comm_bytes.clear()


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
              softcap=None):
    """Position-masked attention, normalized (K4): the serial prefill's
    attention, one launch per attention layer."""
    check_fault("attention")
    dispatch_counts["attention"] += 1
    return striped_flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap)


def attention_partial(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                      softcap=None) -> Partial:
    """Unnormalized position-masked attention partial (K4 with its row
    LSE): the reference's ``partial_attention(q, k, v,
    mask_from_positions(q_pos, k_pos, causal, window), softcap)``, one
    launch per ESP ring step.  K4 returns the normalized output in f32 (for
    bf16 operands too: the reference merges f32 partials) and each row's
    log-sum-exp; as a partial that is ``(o, m = lse, l = 1)`` — the
    same (o, m, l) class under `merge_partial` and `finalize_partial`.  A
    row with no visible key (K4's ``o = 0, lse = +inf``) becomes the empty
    partial ``m = -inf, l = 0``.  On a CPU tensor the same conversion runs
    over K4's plain version with its LSE.  Refuses inputs that require
    grad."""
    check_fault("attention_partial")
    dispatch_counts["attention_partial"] += 1
    b, sq, h, d = q.shape
    if sq == 0 or k.shape[1] == 0:
        return empty_partial(b, sq, h, d, device=q.device)
    o, lse = striped_flash_attention_lse(q, k, v, q_pos, k_pos, causal=causal,
                                         window=window, softcap=softcap)
    lse = lse.transpose(1, 2)  # [B, Sq, H]
    empty = torch.isinf(lse)
    m = torch.where(empty, torch.full((), -torch.inf, device=q.device), lse)
    return Partial(o=o, m=m.float(), l=(~empty).float())


def decode_partial(q, k, v, lengths, *, k_pos_offset=0, window=None,
                   softcap=None) -> Partial:
    """Per-request decode partial over a dense KV shard (K5): the serial
    decode step's history partial, one launch per attention layer."""
    check_fault("decode_partial")
    dispatch_counts["decode_partial"] += 1
    return flash_decode_partial(q, k, v, lengths, k_pos_offset=k_pos_offset,
                                window=window, softcap=softcap)


def prefill_packed(q, k, v, seq_offsets, *, window=None, softcap=None):
    """Packed ragged causal prefill: ONE launch for a whole prefill batch
    concatenated on a single token axis (K1).  The kernel bounds each
    tile's key range from the offsets themselves, so the reference's static
    ``max_seq_len`` reach bound (its banded XLA fallback) has no
    counterpart."""
    check_fault("prefill_packed")
    dispatch_counts["prefill_packed"] += 1
    return packed_flash_prefill(q, k, v, seq_offsets, window=window,
                                softcap=softcap)


def prefill_ring_chunk(q, k, v, q_offsets, k_offsets, carry=None, *,
                       q_shard: int, k_shard: int, n_shards: int,
                       window=None, softcap=None):
    """One ring step of the DoP>1 ESP packed prefill (K3): fold one striped
    KV chunk into the carried unnormalized (o, m, l) flash state.
    ``carry=None`` starts an empty state (m=-inf).  Finalize after the last
    step with ``o / l`` (l==0 rows are bucket padding)."""
    check_fault("prefill_ring_chunk")
    dispatch_counts["prefill_ring_chunk"] += 1
    return packed_flash_prefill_ring_chunk(
        q, k, v, q_offsets, k_offsets, carry, q_shard=q_shard,
        k_shard=k_shard, n_shards=n_shards, window=window, softcap=softcap,
    )


def paged_decode_partial(q, k_pages, v_pages, block_table, lengths,
                         page_pos=None, *, query_pos=None, window=None,
                         softcap=None) -> Partial:
    """Batched ragged decode over the paged pool: ONE launch for every
    request of this instance (K2)."""
    check_fault("paged_decode_partial")
    dispatch_counts["paged_decode_partial"] += 1
    return paged_flash_decode_partial(
        q, k_pages, v_pages, block_table, lengths, page_pos,
        query_pos=query_pos, window=window, softcap=softcap,
    )


# ------------------------------------------------------------ collectives
def _leaves(operands):
    return tuple(operands) if isinstance(operands, (tuple, list)) else (operands,)


def _payload_bytes(operands) -> int:
    """Per-rank payload bytes of a collective's operands."""
    return sum(x.numel() * x.element_size() for x in _leaves(operands))


class Pending:
    """An asynchronous collective in flight: `wait()` returns its result
    (the structure of the operands: one tensor or a tuple)."""

    def __init__(self, outs, works, single: bool, keep=()):
        self._outs, self._works, self._single = outs, works, single
        self._keep = keep  # send buffers must outlive the transfer

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._keep = [], ()
        return self._outs[0] if self._single else tuple(self._outs)


def _finish(outs, works, operands, async_op: bool, keep=()):
    p = Pending(outs, works, not isinstance(operands, (tuple, list)), keep)
    return p if async_op else p.wait()


def _count(key: str, kind: str, operands, group) -> None:
    """Add a collective's per-rank payload to `comm_bytes[key]` and report
    it to the census as one of ``kind`` (a `census.COLLECTIVES` class)."""
    b = _payload_bytes(operands)
    comm_bytes[key] += b
    if census.active():
        census.report_collective(kind, b, dist.get_world_size(group))


def count_transfer(key: str, operands) -> None:
    """Account an explicit transfer under `comm_bytes[key]`."""
    comm_bytes[key] += _payload_bytes(operands)


def _send_recv(key, operands, group, pairs, async_op):
    """One `batch_isend_irecv` of the operands over ``pairs`` (src, dst) of
    group ranks; a rank with no source gets zeros."""
    dispatch_counts[key] += 1
    ranks = dist.get_process_group_ranks(group)
    r = dist.get_rank(group)
    xs = [x.contiguous() for x in _leaves(operands)]
    outs = [torch.zeros_like(x) for x in xs]
    ops_ = []
    for src, dst in pairs:
        if src == r:
            _count(key, "collective-permute", xs, group)
            ops_ += [dist.P2POp(dist.isend, x, ranks[dst], group, tag=i)
                     for i, x in enumerate(xs)]
        if dst == r:
            ops_ += [dist.P2POp(dist.irecv, o, ranks[src], group, tag=i)
                     for i, o in enumerate(outs)]
    works = dist.batch_isend_irecv(ops_) if ops_ else []
    return _finish(outs, works, operands, async_op, keep=xs)


def ring_ppermute(operands, group, *, async_op: bool = False):
    """Forward the operands one step around the ring of ``group``: ONE
    `batch_isend_irecv` that sends to group rank r+1 and receives from
    r-1 (the reference's `lax.ppermute` over `striped.ring_pairs`).  Every
    ring leg of the SPMD prefill goes through here (one dispatch and the
    per-rank payload bytes per leg).  ``async_op=True`` returns a `Pending`
    at once — the double-buffered ring posts the next leg before the
    fold."""
    n = dist.get_world_size(group)
    return _send_recv("ring_ppermute", operands, group,
                      [(i, (i + 1) % n) for i in range(n)], async_op)


def ppermute(operands, group, pairs):
    """The reference's `lax.ppermute` over ``pairs`` of group ranks: each
    rank sends the operands to its destination in ``pairs`` (if any) and
    receives from its source (if any); a rank with no source gets zeros.
    Pairwise transfers, not a ring: the sequence-parallel recurrent layers'
    conv handoff and Hillis-Steele scans shift by 1, 2, 4, ... ranks
    through here."""
    return _send_recv("ppermute", operands, group, pairs, False)


def _all_reduce(key, op, operands, group, async_op):
    dispatch_counts[key] += 1
    _count(key, "all-reduce", operands, group)
    outs = [x.clone(memory_format=torch.contiguous_format)
            for x in _leaves(operands)]
    works = [dist.all_reduce(o, op=op, group=group, async_op=True)
             for o in outs]
    return _finish(outs, works, operands, async_op)


def psum(operands, group, *, async_op: bool = False):
    """Counted all-reduce SUM: the SPMD decode LSE-merge reduces the
    weighted (o·exp(m-M), l·exp(m-M)) accumulators across the KV shards
    through here.  Bytes are the per-rank payload (the reduced tensor size),
    not wire volume."""
    return _all_reduce("psum", dist.ReduceOp.SUM, operands, group, async_op)


def pmax(operands, group, *, async_op: bool = False):
    """Counted all-reduce MAX (the decode merge's global running max M)."""
    return _all_reduce("pmax", dist.ReduceOp.MAX, operands, group, async_op)


def psum_scatter(operands, group, *, scatter_dimension: int = 0,
                 tiled: bool = True, async_op: bool = False):
    """Counted reduce-scatter: the batch-sharded decode merge reduces the
    weighted accumulators AND hands each rank only its own slice of the
    result (the paper's "send back partial results" addressed to the
    masters, §4.2).  Bytes are the per-rank payload contributed (the full
    pre-scatter tensor), like `psum`."""
    assert tiled and scatter_dimension == 0, (tiled, scatter_dimension)
    dispatch_counts["psum_scatter"] += 1
    _count("psum_scatter", "reduce-scatter", operands, group)
    n = dist.get_world_size(group)
    xs = [x.contiguous() for x in _leaves(operands)]
    outs = [x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:])) for x in xs]
    works = [dist.reduce_scatter_tensor(o, x, op=dist.ReduceOp.SUM,
                                        group=group, async_op=True)
             for o, x in zip(outs, xs)]
    return _finish(outs, works, operands, async_op, keep=xs)


def all_gather(operands, group, *, axis: int = 0, tiled: bool = True,
               key: str = "all_gather"):
    """Counted all-gather, concatenating the ranks' slices on ``axis`` in
    group-rank order: the batch-sharded decode boundary's q-slice exchange,
    the in-program sampled-token / new-KV exchanges and the unified step's
    hidden-state and KV stripes.  Bytes are the per-rank payload
    contributed (the LOCAL slice).  ``key`` names the counter (the ring
    prefill's output gather counts under its own)."""
    assert tiled, tiled
    dispatch_counts[key] += 1
    _count(key, "all-gather", operands, group)
    n = dist.get_world_size(group)
    outs = []
    for x in _leaves(operands):
        x0 = x.movedim(axis, 0).contiguous()
        out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
        dist.all_gather_into_tensor(out, x0, group=group)
        outs.append(out.movedim(0, axis))
    return outs[0] if not isinstance(operands, (tuple, list)) else tuple(outs)


def broadcast(operands, src: int, *, group=None, key: str = "broadcast"):
    """Counted broadcast from global rank ``src`` (in place on every other
    rank's buffers, which must have the operands' shapes and dtypes).  The
    mesh executor hands a step's results to the ranks that did not compute
    them through here, and the per-shard decode loop brings each remote
    shard's partial home."""
    dispatch_counts[key] += 1
    _count(key, "collective-permute", operands, group)
    for x in _leaves(operands):
        dist.broadcast(x, src=src, group=group)
    return operands
