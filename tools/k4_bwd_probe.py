#!/usr/bin/env python3
"""Time each pass of the K4 backward (csrc/striped_attention_bwd.cu) on a
CUDA card.

    python3 tools/k4_bwd_probe.py

Builds the backward and the forward it needs, prints the backward's
``-Xptxas -v`` lines and HGMMA counts (`chip_smoke._bwd_build_report`) and
holds the bf16 route against the plain backward formula
(`chip_smoke._check_bwd`) at two small shapes and at the shapes
chip_smoke.py times it: the lwm-7b train shape (B 2, S 4096, H = KVH = 32,
D 128, causal) and mixtral width (B 1, S 6144, H 32 / KVH 8, window 4096),
bf16.  At those two it prints the call's time (CUDA events) and each
kernel's mean duration from torch.profiler: the delta pass, the dk / dv
grid (4 products per attended pair) and the dq grid (3), with the TFLOP/s
each grid reaches on its own products, and SDPA's backward the same way.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _kernel_ms(call, n=5):
    """{kernel name: mean device ms per call} from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if us > 0:
            out[e.key] = us / 1e3 / n
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import striped_attention as sa

    import torch.nn.functional as F

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    for name in ("striped_attention", "striped_attention_bwd"):
        _build.load_library(name)
    log = []
    cs._bwd_build_report(log)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    ar = np.arange
    # (tag, B, Sq, Sk, H, KVH, D, causal, window, softcap, (q_pos, k_pos))
    checks = [
        ("GQA 12 D=80 window softcap", 1, 300, 300, 24, 2, 80, True, 37, 30.0,
         (ar(300), ar(300))),
        ("D=256 Sq=130 Sk=150", 2, 130, 150, 4, 2, 256, True, 50, 20.0,
         (ar(130) + 20, ar(150))),
    ]
    timed = [
        ("lwm-7b B=2 S=4096", 2, 4096, 4096, 32, 32, 128, True, None, None,
         (ar(4096), ar(4096))),
        ("mixtral S=6144 window=4096", 1, 6144, 6144, 32, 8, 128, True, 4096, None,
         (ar(6144), ar(6144))),
    ]
    for tag, b, sq, sk, h, kvh, d, causal, window, softcap, (qp, kp) in checks + timed:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, k, v, do = randn(b, sq, h, d), randn(b, sk, kvh, d), randn(b, sk, kvh, d), \
            randn(b, sq, h, d)
        qpd, kpd = (torch.as_tensor(x, dtype=torch.int32, device=dev) for x in (qp, kp))
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = sa._launch(q, k, v, qpd, kpd, lse=True, **kw)
        got = sa._launch_bwd(q, k, v, o, do, lse, qpd, kpd, **kw)
        rows = max(1, 2 ** 26 // (b * h * sk))
        want = ref.striped_flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), o.float(), do.float(), lse, qpd, kpd,
            rows=rows, **kw)
        cs._check_bwd(tag, got, want, log, True)
        del got, want
        if tag not in [t[0] for t in timed]:
            continue
        pairs = cs._attended_pairs(qp, kp, causal, window) * b * h
        gf = 2 * d * pairs / 1e9  # GFLOP of one product over every attended pair
        ms = cs._time_ms(lambda: sa._launch_bwd(q, k, v, o, do, lse, qpd, kpd, **kw),
                         5, 2)
        per = _kernel_ms(lambda: sa._launch_bwd(q, k, v, o, do, lse, qpd, kpd, **kw))
        print(f"[probe {card}] K4 bwd {tag}: call {ms:.3f} ms (events), "
              f"{5 * gf / ms:.1f} TFLOP/s on the function's 5 products")
        for kern, t in sorted(per.items(), key=lambda x: -x[1]):
            n_prod = 4 if "dkdv" in kern else 3 if "dq" in kern else 0
            rate = f", {n_prod * gf / t:.1f} TFLOP/s on its {n_prod} products" \
                if n_prod else ""
            print(f"  {kern[:90]}: {t:.3f} ms{rate}")
        q4 = q.transpose(1, 2).contiguous().requires_grad_(True)
        k4, v4 = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_(True) for x in (k, v))
        if window is None:
            sdpa_kw = dict(is_causal=True)
        else:
            dd = qpd[:, None] - kpd[None, :]
            sdpa_kw = dict(attn_mask=(dd >= 0) & (dd < window))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw)
        do4 = do.transpose(1, 2).contiguous()
        per = _kernel_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                     retain_graph=True))
        print(f"  SDPA backward: {sum(per.values()):.3f} ms of kernels, "
              f"{5 * gf / sum(per.values()):.1f} TFLOP/s on 5 products")
        for kern, t in sorted(per.items(), key=lambda x: -x[1])[:4]:
            print(f"    {kern[:90]}: {t:.3f} ms")
        del q4, k4, v4, out4, do4
    print("\n".join(log))
    return 0


if __name__ == "__main__":
    sys.exit(main())
