"""Flash-decode partial over one dense KV shard (K5).

PyTorch counterpart of `repro/kernels/flash_decode.py`, run by the
hand-written CUDA kernel in `csrc/flash_decode.cu`.  It is the history
partial of every serial decode step (`DefaultAttnImpl.decode_attn`).  The
wrapper:

  * on a CPU tensor, returns the plain PyTorch version
    (`ref.flash_decode_partial_ref`, one dense masked partial);
  * on a CUDA tensor, launches the kernel (counted in `launch_counts`) or
    raises on what the kernel does not take.  Nothing falls back.

Contract: ``q`` [B, 1, H, D]; ``k``/``v`` [B, S, KVH, D], the KV shard whose
first key sits at global position ``k_pos_offset``; ``lengths`` [B] each
request's global valid cache length, which may exceed ``k_pos_offset + S``
(a shard of a longer cache).  Valid keys: ``kpos < lengths`` and, windowed,
``kpos > lengths - window`` (the query sits at ``lengths``; its own KV is
merged apart).  Returns the unnormalized ``Partial(o [B,1,H,D], m, l
[B,1,H])`` in f32; an empty row gives ``m = -inf, l = 0``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels.ref import flash_decode_partial_ref
from repro_torch.models.attention import Partial, empty_partial

#: kernel launches on CUDA tensors (comparisons with the plain version and
#: CPU calls are not launches of the kernel)
launch_counts: Counter = Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

flash_decode_partial_plain = flash_decode_partial_ref


def _launch(q, k, v, lengths, *, k_pos_offset, window, softcap) -> Partial:
    from repro_torch.kernels import _build

    if q.device.type != "cuda":
        raise ValueError(f"flash_decode kernel: tensors on {q.device}")
    b, sq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if sq != 1:
        raise ValueError("flash_decode kernel: one query token per request")
    if (k.shape != (b, s, kvh, d) or v.shape != k.shape or h % kvh
            or h // kvh > 64 or d % 8 or d > 256):
        raise ValueError(f"flash_decode kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (need "
                         "h % kvh == 0, h / kvh <= 64, d % 8 == 0, d <= 256)")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise TypeError(f"flash_decode kernel: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode kernel: window {window} < 1")
    dev = q.device
    lens = torch.as_tensor(lengths).to(dev, torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"flash_decode kernel: lengths {tuple(lens.shape)} "
                         f"for batch {b}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((b, 1, h, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, 1, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, 1, h), dtype=torch.float32, device=dev)
    lib = _build.load_library("flash_decode")
    P = _build.ptr
    err = lib.repro_flash_decode(
        P(q), P(k), P(v), P(lens), P(o), P(m), P(l), b, s, h, kvh, d,
        int(k_pos_offset), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "flash_decode", err)
    return Partial(o=o, m=m, l=l)


def flash_decode_partial(q, k, v, lengths, *, k_pos_offset: int = 0,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> Partial:
    """K5: one launch over the dense KV shard; returns the unnormalized
    Partial of every request's query over it."""
    if q.device.type == "cpu":
        return flash_decode_partial_plain(q, k, v, lengths,
                                          k_pos_offset=k_pos_offset,
                                          window=window, softcap=softcap)
    b, sq, h, d = q.shape
    if b == 0 or k.shape[1] == 0:  # an empty shard
        return empty_partial(b, sq, h, d, device=q.device)
    out = _launch(q, k, v, lengths, k_pos_offset=k_pos_offset, window=window,
                  softcap=softcap)
    launch_counts["flash_decode_partial"] += 1
    return out
