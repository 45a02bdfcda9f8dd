"""Packed ragged prefill: the model-side plug for the packed-prefill kernel.

The engine arms the impl for one packed prefill step (`begin_step` with the
batch's segment offsets), runs the model's `prefill_packed` entry point, and
disarms.  Per layer the impl issues exactly ONE `ops.prefill_packed` launch
(K1) for the whole batch instead of O(batch) per-request prefills.  DoP>1
ESP groups arm it with ``dop=n``: the packed axis is striped across the
group's n instances and attention runs the fused striped ring replayed in
process (`core.esp.ring_packed_prefill`, n launches of K3 per ring step).

The impl subclasses `DefaultAttnImpl`, so outside a `begin_step`/`end_step`
window it behaves exactly like the default dense math.
"""
from __future__ import annotations

from repro_torch.kernels import ops
from repro_torch.models.transformer import DefaultAttnImpl


class PackedPrefillAttnImpl(DefaultAttnImpl):
    """Segment-masked causal attention over a packed ragged prefill batch."""

    def __init__(self):
        self._offsets = None  # [B+1] packed segment boundaries (numpy)
        self._dop: int = 1  # ESP group size: >1 runs the fused striped ring

    def begin_step(self, seq_offsets, dop: int = 1) -> None:
        """Arm the packed path for one prefill step; with ``dop > 1`` the
        packed token axis (bucketed to a multiple of dop) stripes across the
        group and attention runs the fused ring."""
        self._offsets = seq_offsets
        self._dop = int(dop)

    def end_step(self) -> None:
        self._offsets = None
        self._dop = 1

    def prefill_attn(self, q, k, v, q_pos, k_pos, *, causal, window, softcap):
        if self._offsets is None:
            return super().prefill_attn(
                q, k, v, q_pos, k_pos, causal=causal, window=window,
                softcap=softcap,
            )
        assert q.shape[0] == 1, "packed prefill uses batch dim 1"
        if self._dop > 1:
            from repro_torch.core.esp import ring_packed_prefill

            out = ring_packed_prefill(
                q[0], k[0], v[0], self._offsets, self._dop, window=window,
                softcap=softcap,
            )
        else:
            out = ops.prefill_packed(
                q[0], k[0], v[0], self._offsets, window=window,
                softcap=softcap,
            )
        return out[None].to(q.dtype)
