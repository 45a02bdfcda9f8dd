"""How ``correct`` is decided: the tokens the engine served, held against
the plain reference (`esp_bench/reference/`).

Once the window has closed and the program's state is freed, a sample of
the requests that finished in the window is drawn from the seed, with
the longest of them in it, until it holds ``SAMPLE_TOKENS`` served tokens.
The reference runs once over each prompt followed by its served tokens;
at the position before each served token it gives float32 logits, and the
number compared is the widest gap by which a served token's logit lies
below the reference's best there.  Greedy serving of a correct program
reads a gap of rounding only; a wrong token, a stale cache or a dropped
layer reads the spread of the logits.

The control (``lowp``) runs the reference in float8 e4m3 over the same
prompts and tokens and reads, at each position, the gap of the token that
the lower precision puts first; ``run.py --control`` puts it in the
program's place, judged by the same limit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

SAMPLE_TOKENS = 256
SAMPLE_MAX = 8


def finished(rec) -> List[Dict]:
    return [d for d in rec.reqs if d["n_out"] >= d["out_len"]]


def sample(rec, seed: int) -> List[Dict]:
    """The longest finished request, then others in an order drawn from
    the seed, until SAMPLE_TOKENS served tokens or SAMPLE_MAX requests."""
    fin = finished(rec)
    if not fin:
        return []
    fin.sort(key=lambda d: (-(d["prompt_len"] + d["out_len"]), d["rid"]))
    out, rest = [fin[0]], fin[1:]
    n = fin[0]["out_len"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 4])
    for j in rng.permutation(len(rest)):
        if n >= SAMPLE_TOKENS or len(out) >= SAMPLE_MAX:
            break
        out.append(rest[j])
        n += rest[j]["out_len"]
    return out


def gaps(cfg: Dict, params: Dict, reqs: List[Dict], device,
         lowp: Optional[str] = None) -> List[float]:
    """Per sampled request, the widest gap below the reference's best of
    the served tokens (or, with `lowp`, of the control's first choices)."""
    from esp_bench import lookup

    logits_at = lookup.reference(cfg).logits_at
    out = []
    for d in reqs:
        served = list(d["served"])
        seq = list(d["prompt"]) + served[:-1]
        toks = torch.as_tensor(seq, dtype=torch.long, device=device)
        p = d["prompt_len"]
        rows = torch.arange(p - 1, p - 1 + len(served), device=device)
        ref = logits_at(cfg, params, toks, rows)
        if lowp is None:
            pick = torch.as_tensor(served, dtype=torch.long, device=device)
        else:
            pick = logits_at(cfg, params, toks, rows, lowp=lowp).argmax(-1)
        best = ref.max(-1).values
        got = ref.gather(1, pick[:, None])[:, 0]
        out.append(float((best - got).max()))
        del ref
    return out
