"""Striped sequence permutation (Striped Attention, Brandon et al. 2023).

Token t of the original sequence is assigned to SP rank (t mod n) at local
offset (t div n).  Striping balances causal-mask work across ranks: at every
ring step each rank computes an (almost) equal number of unmasked entries.
All model math is position-based (RoPE, masks), so running the model on the
permuted layout with the matching `positions` is exact.

The port's copy of `repro/core/striped.py`: index helpers in numpy, the
permutations on torch tensors.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def stripe_indices(seq_len: int, n: int) -> np.ndarray:
    """perm[i] = original index of the i-th token in striped layout (the
    concatenation of per-rank stripes; seq_len must be divisible by n)."""
    assert seq_len % n == 0, (seq_len, n)
    local = seq_len // n
    return np.arange(seq_len).reshape(local, n).T.reshape(-1)


def unstripe_indices(seq_len: int, n: int) -> np.ndarray:
    """inv[j] = position in striped layout of original token j."""
    perm = stripe_indices(seq_len, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def unstripe(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    idx = torch.as_tensor(unstripe_indices(x.shape[axis], n), device=x.device)
    return x.index_select(axis, idx)


def ring_pairs(n: int) -> List[Tuple[int, int]]:
    """(src, dst) pairs of an n-rank ring."""
    return [(i, (i + 1) % n) for i in range(n)]


def ring_chunk_schedule(n: int) -> List[List[int]]:
    """``sched[step][rank]`` — which rank's original KV chunk each rank holds
    at every ring step, by simulating the `ring_pairs` rotation (every rank
    starts with its own chunk; each step forwards it to the neighbour)."""
    pairs = ring_pairs(n)
    held = list(range(n))
    sched = [list(held)]
    for _ in range(n - 1):
        nxt = list(held)
        for src, dst in pairs:
            nxt[dst] = held[src]
        held = nxt
        sched.append(list(held))
    return sched


def shard_offsets(seq_offsets, n: int, shard: int) -> np.ndarray:
    """Per-shard segment offsets of a striped packed axis: entry b is the
    number of shard-local tokens with global packed index < seq_offsets[b]
    (global index g lives on shard g % n at local slot g // n)."""
    off = np.asarray(seq_offsets, np.int64)
    return np.maximum((off - shard + n - 1) // n, 0).astype(np.int32)


def all_shard_offsets(seq_offsets, n: int) -> np.ndarray:
    """[n, B+1] per-shard segment offsets, stacked (row r =
    `shard_offsets(.., n, r)`)."""
    return np.stack([shard_offsets(seq_offsets, n, r) for r in range(n)])
