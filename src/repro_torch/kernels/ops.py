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
"""
from __future__ import annotations

from collections import Counter

from repro_torch.kernels.flash_decode import flash_decode_partial
from repro_torch.kernels.paged_flash_decode import paged_flash_decode_partial
from repro_torch.kernels.paged_flash_prefill import (
    packed_flash_prefill,
    packed_flash_prefill_ring_chunk,
)
from repro_torch.kernels.striped_attention import striped_flash_attention
from repro_torch.models.attention import Partial


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


def reset_dispatch_counts() -> None:
    dispatch_counts.clear()


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
              softcap=None):
    """Position-masked attention, normalized (K4): the serial prefill's
    attention, one launch per attention layer."""
    check_fault("attention")
    dispatch_counts["attention"] += 1
    return striped_flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap)


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
