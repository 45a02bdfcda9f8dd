"""Position-masked flash attention (K4).

PyTorch counterpart of `repro/kernels/striped_attention.py`, run by the
hand-written CUDA kernel in `csrc/striped_attention.cu`.  It is the
attention of every serial prefill (`DefaultAttnImpl.prefill_attn`).  The
wrapper:

  * on a CPU tensor, returns the plain PyTorch version
    (`ref.striped_flash_attention_ref`, the dense `full_attention`);
  * on a CUDA tensor, launches the kernel (counted in `launch_counts`) or
    raises on what the kernel does not take.  Nothing falls back.

Contract: ``q`` [B, Sq, H, D], ``k``/``v`` [B, Sk, KVH, D] of one dtype (f32
or bf16), ``q_pos`` [Sq] / ``k_pos`` [Sk] integer global positions in any
order (striped layouts allowed); mask ``q_pos >= k_pos`` when causal and
``q_pos - k_pos < window`` (self-inclusive); tanh softcap.  Returns the
normalized output [B, Sq, H, D] in q's dtype; a row with no key is zeros.
Unlike the TPU kernel, Sq and Sk need not divide any block size.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels.ref import striped_flash_attention_ref

#: kernel launches on CUDA tensors (comparisons with the plain version and
#: CPU calls are not launches of the kernel)
launch_counts: Counter = Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

striped_flash_attention_plain = striped_flash_attention_ref


def _positions(pos, n: int, dev) -> torch.Tensor:
    p = torch.as_tensor(pos).to(dev, torch.int32).contiguous()
    if p.shape != (n,):
        raise ValueError(f"striped_attention kernel: positions "
                         f"{tuple(p.shape)}, need [{n}]")
    return p


def _launch(q, k, v, q_pos, k_pos, *, causal, window, softcap):
    from repro_torch.kernels import _build

    if q.device.type != "cuda":
        raise ValueError(f"striped_attention kernel: tensors on {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"striped_attention kernel: dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} (need one of f32 / bf16)")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if (k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh
            or h // kvh > 64 or d % 8 or d > 256 or b > 65535):
        raise ValueError(f"striped_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (need "
                         "h % kvh == 0, h / kvh <= 64, d % 8 == 0, d <= 256)")
    if window is not None and window < 1:
        raise ValueError(f"striped_attention kernel: window {window} < 1")
    dev = q.device
    qp, kp = _positions(q_pos, sq, dev), _positions(k_pos, sk, dev)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lib = _build.load_library("striped_attention")
    P = _build.ptr
    err = lib.repro_striped_attention(
        P(q), P(k), P(v), P(qp), P(kp), P(o), b, sq, sk, h, kvh, d,
        _DTYPE_CODE[q.dtype], int(bool(causal)),
        int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "striped_attention", err)
    return o


def striped_flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """K4: one launch of position-masked flash attention; returns the
    normalized output [B, Sq, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return striped_flash_attention_plain(q, k, v, q_pos, k_pos,
                                             causal=causal, window=window,
                                             softcap=softcap)
    if q.shape[1] == 0 or k.shape[1] == 0:  # no query, or no key: zeros
        return torch.zeros_like(q)
    out = _launch(q, k, v, q_pos, k_pos, causal=causal, window=window,
                  softcap=softcap)
    launch_counts["striped_flash_attention"] += 1
    return out
