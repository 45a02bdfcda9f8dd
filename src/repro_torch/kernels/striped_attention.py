"""Position-masked flash attention (K4) and its gradient.

PyTorch counterpart of `repro/kernels/striped_attention.py`, run by the
hand-written CUDA kernel in `csrc/striped_attention.cu`.  It is the
attention of every serial prefill and of every train step
(`DefaultAttnImpl.prefill_attn`).  The wrapper:

  * on a CPU tensor, returns the plain PyTorch version
    (`ref.striped_flash_attention_ref`, the dense `full_attention`);
  * on a CUDA tensor, launches the kernel (counted in `launch_counts`) or
    raises on what the kernel does not take.  Nothing falls back.

Under a gradient (grad mode on and any of q, k, v requiring grad) the call
goes through `StripedFlashAttentionFn`: its forward also keeps each row's
log-sum-exp, and its backward is the hand-written kernel of
`csrc/striped_attention_bwd.cu` (counted under
``"striped_flash_attention_bwd"``).  On CPU tensors the same `Function`
runs the plain forward with its LSE (`ref.striped_flash_attention_ref_lse`)
and the plain backward formula (`ref.striped_flash_attention_bwd_ref`).

On a meta tensor (the dry run, `launch.dryrun`) each entry returns outputs
of the right shape and dtype and computes nothing.  On every device each
call reports its work by shape to the op census (`launch.census`), and
what runs to do it runs uncounted.

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

from repro_torch.kernels.ref import (
    striped_flash_attention_bwd_ref,
    striped_flash_attention_ref,
    striped_flash_attention_ref_lse,
)
from repro_torch.launch import census

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


def _check_operands(q, k, v, window):
    """Raise on what the kernels (forward and backward) do not take."""
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


def _report(q, k, *, causal, window, lse=False, o_f32=False,
            backward=False):
    """Report one call's work to the census, from shapes: the forward reads
    q, k, v and both position vectors (int32) and writes o (and the f32
    row LSE); the backward reads q, k, v, o, do, the LSE and the positions
    and writes dq, dk, dv."""
    if not census.active():
        return
    b, sq, h, d = q.shape
    sk = k.shape[1]
    es = q.element_size()
    q_b, kv_b = q.numel() * es, 2 * k.numel() * es
    pos_b, lse_b = 4 * (sq + sk), 4 * b * h * sq
    flops = census.attention_flops(b, sq, sk, h, d, causal=causal,
                                   window=window, backward=backward)
    if backward:
        census.report_kernel("K4 bwd", flops,
                             3 * q_b + kv_b + lse_b + pos_b + q_b + kv_b)
    else:
        o_b = q.numel() * (4 if o_f32 else es)
        census.report_kernel("K4", flops, q_b + kv_b + pos_b + o_b
                             + (lse_b if lse else 0))


def _mask_args(causal, window, softcap):
    return (int(bool(causal)), int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0)


def _launch(q, k, v, q_pos, k_pos, *, causal, window, softcap, lse=False,
            o_f32=False):
    """One forward launch; returns o, or (o, lse [B, H, Sq] f32) with
    ``lse=True``.  o is in q's dtype, or f32 with ``o_f32`` (the bf16
    route's normalized accumulator before it is rounded)."""
    from repro_torch.kernels import _build

    _check_operands(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dev = q.device
    qp, kp = _positions(q_pos, sq, dev), _positions(k_pos, sk, dev)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q, dtype=torch.float32 if o_f32 else q.dtype)
    row_lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if lse else None
    lib = _build.load_library("striped_attention")
    P = _build.ptr
    err = lib.repro_striped_attention(
        P(q), P(k), P(v), P(qp), P(kp), P(o), P(row_lse), b, sq, sk, h, kvh, d,
        _DTYPE_CODE[q.dtype], int(bool(o_f32)), *_mask_args(causal, window, softcap),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "striped_attention", err)
    return (o, row_lse) if lse else o


def _launch_bwd(q, k, v, o, do, lse, q_pos, k_pos, *, causal, window,
                softcap):
    """One backward call (the delta pass, the dk / dv grid and the dq grid,
    no atomics: two calls on the same inputs are bitwise equal); returns
    (dq, dk, dv) in the operands' dtype.  bf16 operands run every product on
    the tensor cores (wgmma; P and dS rounded to bf16 before their
    products), f32 operands the fp32-FMA bodies."""
    from repro_torch.kernels import _build

    _check_operands(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32):
        raise ValueError(f"striped_attention_bwd kernel: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dev = q.device
    qp, kp = _positions(q_pos, sq, dev), _positions(k_pos, sk, dev)
    q, k, v, o, lse = (x.contiguous() for x in (q, k, v, o, lse))
    do = do.to(q.dtype).contiguous()  # autograd may hand a strided gradient
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = _build.load_library("striped_attention_bwd")
    P = _build.ptr
    err = lib.repro_striped_attention_bwd(
        P(q), P(k), P(v), P(o), P(do), P(lse), P(qp), P(kp), P(dq), P(dk),
        P(dv), P(delta), b, sq, sk, h, kvh, d, _DTYPE_CODE[q.dtype],
        *_mask_args(causal, window, softcap), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "striped_attention_bwd", err)
    return dq, dk, dv


class StripedFlashAttentionFn(torch.autograd.Function):
    """K4 under a gradient.  The forward keeps (q, k, v, o, lse, positions);
    the backward returns (dq, dk, dv).  The tensor's device decides what
    runs: the CUDA kernels, or on the CPU the plain forward with its LSE and
    the plain backward formula."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, softcap):
        kw = dict(causal=causal, window=window, softcap=softcap)
        _report(q, k, causal=causal, window=window, lse=True)
        with census.uncounted():
            if q.device.type == "cpu":
                # contiguous, as the kernel's output is (the ops after it
                # then run alike on every device)
                o, lse = (x.contiguous() for x in striped_flash_attention_ref_lse(
                    q, k, v, q_pos, k_pos, **kw))
            elif q.device.type == "meta":  # contiguous, as the kernel's
                o = q.new_empty(q.shape)
                lse = q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                                  dtype=torch.float32)
            else:
                o, lse = _launch(q, k, v, q_pos, k_pos, lse=True, **kw)
                launch_counts["striped_flash_attention"] += 1
            ctx.save_for_backward(q, k, v, o, lse,
                                  torch.as_tensor(q_pos).to(q.device),
                                  torch.as_tensor(k_pos).to(q.device))
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qp, kp = ctx.saved_tensors
        _report(q, k, causal=ctx.kw["causal"], window=ctx.kw["window"],
                backward=True)
        with census.uncounted():
            if q.device.type == "cpu":
                dq, dk, dv = (x.contiguous() for x in striped_flash_attention_bwd_ref(
                    q, k, v, o, do, lse, qp, kp, **ctx.kw))
            elif q.device.type == "meta":
                dq, dk, dv = (x.new_empty(x.shape) for x in (q, k, v))
            else:
                dq, dk, dv = _launch_bwd(q, k, v, o, do, lse, qp, kp, **ctx.kw)
                launch_counts["striped_flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None, None


def striped_flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """K4: one launch of position-masked flash attention; returns the
    normalized output [B, Sq, H, D] in q's dtype.  Under a gradient the
    output carries `StripedFlashAttentionFn`'s backward."""
    if q.shape[1] == 0 or k.shape[1] == 0:  # no query, or no key: zeros
        return torch.zeros_like(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return StripedFlashAttentionFn.apply(q, k, v, q_pos, k_pos, causal,
                                             window, softcap)
    _report(q, k, causal=causal, window=window)
    with census.uncounted():
        if q.device.type == "cpu":
            return striped_flash_attention_plain(
                q, k, v, q_pos, k_pos, causal=causal, window=window,
                softcap=softcap).contiguous()
        if q.device.type == "meta":
            return q.new_empty(q.shape)
        out = _launch(q, k, v, q_pos, k_pos, causal=causal, window=window,
                      softcap=softcap)
    launch_counts["striped_flash_attention"] += 1
    return out


def striped_flash_attention_lse(q, k, v, q_pos, k_pos, *, causal: bool = True,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None):
    """K4 with its row statistics: one launch that also writes each row's
    log-sum-exp.  Returns (o [B, Sq, H, D] f32 — for bf16 operands the
    normalized accumulator, never rounded to bf16 — and lse [B, H, Sq]
    f32); a row with no key gets o = 0 and lse = +inf.  On a CPU tensor the
    plain forward with its LSE (`ref.striped_flash_attention_ref_lse`, o in
    the accumulation type).
    Refuses inputs that require grad: the ESP ring's partials are serving
    math (training goes through `StripedFlashAttentionFn`)."""
    from repro_torch.kernels import refuse_grad

    refuse_grad("striped_flash_attention_lse", q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _report(q, k, causal=causal, window=window, lse=True, o_f32=True)
    with census.uncounted():
        if q.device.type == "cpu":
            return tuple(x.contiguous() for x in striped_flash_attention_ref_lse(
                q, k, v, q_pos, k_pos, o_acc=True, **kw))
        if q.device.type == "meta":
            b, sq, h, _ = q.shape
            return (q.new_empty(q.shape, dtype=torch.float32),
                    q.new_empty((b, h, sq), dtype=torch.float32))
        out = _launch(q, k, v, q_pos, k_pos, lse=True, o_f32=True, **kw)
    launch_counts["striped_flash_attention"] += 1
    return out
