"""Split-K plan and launch of the decode kernels K2 and K5.

Both run the core in `csrc/decode_splitk.cuh`: pass 1 gives one CTA per
(request, KV head, row block, split) and, when a row's keys are cut into
more than one split, pass 2 merges the per-split partials by log-sum-exp.
How the keys are cut is decided here, on the host, from shapes alone: the
plan never reads ``lengths``, so the decode path takes no device-to-host
sync, and the same shapes always give the same plan (and the same sums).

Rules:
  * a split is a whole number of 64-key tiles;
  * the plan aims at about two CTAs per SM for a single row (K5 on the
    serial path: its one row is exactly as long as the bound), and at
    `RAGGED` times that for a batch, whose rows are as long as the bound
    only at most: cutting them finer keeps the longest request from setting
    the tail;
  * a batch that already brings that many CTAs with one split per row (the
    unified step's thousands of short rows) keeps one split, and pass 1
    writes the partial itself.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.models.attention import Partial

TILE = 64  # keys per planning tile (`kTile` in csrc/decode_splitk.cuh)
H100_SMS = 132
CTAS_PER_SM = 2  # pass-1 CTAs per SM the plan aims at (~96 KB of ring each)
RAGGED = 16  # times more CTAs for a batch of rows of unequal lengths
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rows_per_cta(q_per_kv: int) -> int:
    """q heads of a GQA group that one CTA carries (the kernel's RQ, 1 or
    2); a wider group runs in row blocks of 2, each copying the group's K/V
    again (from L2 for all but the first).  At q_per_kv = 4 (mixtral) two
    blocks of two rows ran faster on the H100 than one of four
    (tools/decode_probe.py)."""
    return 1 if q_per_kv == 1 else 2


def plan(b: int, kvh: int, n_keys_bound: int, *, q_per_kv: int = 1,
         n_sm: int = H100_SMS) -> tuple[int, int]:
    """(n_splits, chunk) for a batch of ``b`` rows whose valid keys number
    at most ``n_keys_bound`` each: split i of a row covers its valid keys
    [lo + i * chunk, min(hi, lo + (i + 1) * chunk)); ``n_splits * chunk >=
    n_keys_bound``, chunk a multiple of `TILE`."""
    ctas = max(1, b * kvh * -(-q_per_kv // rows_per_cta(q_per_kv)))
    tiles = max(1, -(-n_keys_bound // TILE))
    target = CTAS_PER_SM * n_sm * (RAGGED if b > 1 else 1)
    # tiles per split: the batch's CTA-tiles over the target, rounded
    per = min(tiles, max(1, (2 * ctas * tiles + target) // (2 * target)))
    return -(-tiles // per), per * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (a host-side property, cached)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def launch(name: str, inputs, dims, *, q, kvh: int, kv_dtype, n_keys_bound,
           window, softcap) -> Partial:
    """Plan, then launch pass 1 of ``csrc/<name>.cu`` — its arguments: the
    pointers ``inputs``, then o, m, l and the workspace, the ints ``dims``,
    the plan, the dtypes, window, softcap, scale and the stream — and, with
    more than one split, its merge ``repro_<name>_merge``.  Outputs and the
    workspace are allocated here; each launch's error is raised."""
    from repro_torch.kernels import _build

    b, _, h, d = q.shape
    dev = q.device
    n_splits, chunk = plan(b, kvh, n_keys_bound, q_per_kv=h // kvh,
                           n_sm=sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((b, 1, h, d), **f32)
    m = torch.empty((b, 1, h), **f32)
    l = torch.empty((b, 1, h), **f32)
    ws = torch.empty((n_splits, b, h, d + 2), **f32) if n_splits > 1 else None
    lib = _build.load_library(name)
    P = _build.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, f"repro_{name}")(
        *map(P, inputs), P(o), P(m), P(l), P(ws), *dims, n_splits, chunk,
        rows_per_cta(h // kvh), DTYPE_CODE[q.dtype], DTYPE_CODE[kv_dtype],
        int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0, 1.0 / math.sqrt(d),
        stream,
    )
    _build.check(lib, name, err)
    if n_splits > 1:
        err = getattr(lib, f"repro_{name}_merge")(P(ws), P(o), P(m), P(l), b,
                                                  h, d, n_splits, stream)
        _build.check(lib, name, err, "merge")
    return Partial(o=o, m=m, l=l)
