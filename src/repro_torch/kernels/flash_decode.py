"""Flash-decode partial over one dense KV shard (K5).

PyTorch counterpart of `repro/kernels/flash_decode.py`, run by the
hand-written CUDA kernel in `csrc/flash_decode.cu` (the split-K decode core
`csrc/decode_splitk.cuh`, planned by `kernels/decode_split.py`).  It is the
history partial of every serial decode step (`DefaultAttnImpl.decode_attn`).
The wrapper:

  * on a CPU tensor, returns the plain PyTorch version
    (`ref.flash_decode_partial_ref`, one dense masked partial);
  * on a CUDA tensor, launches the kernel — pass 1 and, when the plan cuts
    the rows' keys into several splits, the merge; one call counts one in
    `launch_counts` — or raises on what the kernel does not take.  Nothing
    falls back.

On a meta tensor (the dry run) it returns outputs of the right shape and
dtype and computes nothing.  On every device a call reports its work by
shape to the op census (`launch.census`), and what runs to do it runs
uncounted.

Contract: ``q`` [B, 1, H, D]; ``k``/``v`` [B, S, KVH, D], the KV shard whose
first key sits at global position ``k_pos_offset``; ``lengths`` [B] each
request's global valid cache length, which may exceed ``k_pos_offset + S``
(a shard of a longer cache).  Valid keys: ``kpos < lengths`` and, windowed,
``kpos > lengths - window`` (the query sits at ``lengths``; its own KV is
merged apart).  Returns the unnormalized ``Partial(o [B,1,H,D], m, l
[B,1,H])`` in f32; an empty row gives ``m = -inf, l = 0``.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import decode_split, refuse_grad
from repro_torch.kernels.ref import flash_decode_partial_ref
from repro_torch.launch import census
from repro_torch.models.attention import Partial, empty_partial

#: kernel launches on CUDA tensors (comparisons with the plain version and
#: CPU calls are not launches of the kernel)
launch_counts: Counter = Counter()

flash_decode_partial_plain = flash_decode_partial_ref


def _launch(q, k, v, lengths, *, k_pos_offset, window, softcap) -> Partial:
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode kernel: tensors on {q.device}")
    b, sq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if sq != 1:
        raise ValueError("flash_decode kernel: one query token per request")
    if (k.shape != (b, s, kvh, d) or v.shape != k.shape or h % kvh
            or h // kvh > 64 or d % 8 or not 8 <= d <= 256):
        raise ValueError(f"flash_decode kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (need "
                         "h % kvh == 0, h / kvh <= 64, d % 8 == 0, "
                         "8 <= d <= 256)")
    codes = decode_split.DTYPE_CODE
    if q.dtype not in codes or k.dtype not in codes or v.dtype != k.dtype:
        raise TypeError(f"flash_decode kernel: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode kernel: window {window} < 1")
    lens = torch.as_tensor(lengths).to(q.device, torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"flash_decode kernel: lengths {tuple(lens.shape)} "
                         f"for batch {b}")
    # a row's valid keys: at most S, and under a window at most window - 1
    bound = s if window is None else min(s, int(window) - 1)
    return decode_split.launch(
        "flash_decode", (q.contiguous(), k.contiguous(), v.contiguous(), lens),
        (b, s, h, kvh, d, int(k_pos_offset)), q=q, kvh=kvh, kv_dtype=k.dtype,
        n_keys_bound=bound, window=window, softcap=softcap,
    )


def flash_decode_partial(q, k, v, lengths, *, k_pos_offset: int = 0,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> Partial:
    """K5: one launch over the dense KV shard; returns the unnormalized
    Partial of every request's query over it.  Refuses inputs that require
    grad (`kernels.refuse_grad`)."""
    refuse_grad("flash_decode_partial", q, k, v)
    b, sq, h, d = q.shape
    if census.active():
        # reads q, k, v and the int32 lengths; writes the f32 (o, m, l)
        census.report_kernel(
            "K5", census.attention_flops(b, sq, k.shape[1], h, d,
                                         causal=False, window=window),
            census.nbytes(q, k, v) + 4 * b + 4 * b * sq * h * (d + 2))
    with census.uncounted():
        if q.device.type == "cpu":
            return flash_decode_partial_plain(q, k, v, lengths,
                                              k_pos_offset=k_pos_offset,
                                              window=window, softcap=softcap)
        if q.device.type == "meta":
            return Partial(q.new_empty((b, sq, h, d), dtype=torch.float32),
                           q.new_empty((b, sq, h), dtype=torch.float32),
                           q.new_empty((b, sq, h), dtype=torch.float32))
        if b == 0 or k.shape[1] == 0:  # an empty shard
            return empty_partial(b, sq, h, d, device=q.device)
        out = _launch(q, k, v, lengths, k_pos_offset=k_pos_offset,
                      window=window, softcap=softcap)
    launch_counts["flash_decode_partial"] += 1
    return out
