"""Synthetic workload generators matching the paper's datasets (§7.1).

No network access in this container, so the request length distributions are
parameterized to the ranges the paper reports:
  * ShareGPT: 4 – 2.3K tokens (short conversational; lognormal body)
  * L-Eval:   2.7K – 210.5K  (long-doc QA/summarization)
  * LV-Eval:  15.1K – 497.3K (longest; long-context QA)
  * Mixed:    uniform mixture of the three
Arrivals are Poisson (exponential inter-arrival at the given rate), and the
Zipf resampling used by the paper's Fig. 12 ablation is provided.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.engine.request import Request


@dataclass
class LengthDist:
    lo: int
    hi: int
    log_mu: float
    log_sigma: float
    out_lo: int
    out_hi: int

    def sample(self, rng) -> Tuple[int, int]:
        ln = int(np.clip(rng.lognormal(self.log_mu, self.log_sigma), self.lo, self.hi))
        out = int(rng.integers(self.out_lo, self.out_hi + 1))
        return ln, out


DATASETS = {
    "sharegpt": LengthDist(4, 2300, math.log(320), 1.0, 16, 512),
    "leval": LengthDist(2700, 210_500, math.log(18_000), 1.0, 16, 512),
    "lveval": LengthDist(15_100, 497_300, math.log(80_000), 0.9, 8, 256),
}


def sample_lengths(dataset: str, n: int, seed: int = 0) -> List[Tuple[int, int]]:
    rng = np.random.default_rng(seed)
    if dataset == "mixed":
        names = list(DATASETS)
        return [
            DATASETS[names[int(rng.integers(len(names)))]].sample(rng)
            for _ in range(n)
        ]
    return [DATASETS[dataset].sample(rng) for _ in range(n)]


def poisson_workload(
    dataset: str,
    n: int,
    rate: float,
    seed: int = 0,
    max_len: Optional[int] = None,
) -> List[Request]:
    """Requests with Poisson arrivals at `rate` req/s."""
    rng = np.random.default_rng(seed)
    lens = sample_lengths(dataset, n, seed + 1)
    t = 0.0
    reqs = []
    for ln, out in lens:
        t += rng.exponential(1.0 / rate)
        if max_len:
            ln = min(ln, max_len)
        reqs.append(Request(input_len=ln, max_new_tokens=out, arrival=t))
    return reqs


def zipf_workload(
    n: int,
    zipf_a: float,
    rate: float,
    seed: int = 0,
    max_len: int = 200_000,
) -> List[Request]:
    """Fig. 12: lengths sampled from the Mixed pool reweighted by a Zipf law
    (small `a` -> heavier tail of long requests)."""
    rng = np.random.default_rng(seed)
    pool = sorted(l for l, _ in sample_lengths("mixed", 4096, seed + 1))
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    w = ranks ** (-zipf_a)
    w /= w.sum()
    t = 0.0
    reqs = []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        ln = int(min(pool[int(rng.choice(len(pool), p=w))], max_len))
        out = int(rng.integers(16, 513))
        reqs.append(Request(input_len=max(ln, 4), max_new_tokens=out, arrival=t))
    return reqs


def with_prompts(reqs: List[Request], vocab: int, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    for r in reqs:
        r.prompt = rng.integers(0, vocab, r.input_len).tolist()
    return reqs
