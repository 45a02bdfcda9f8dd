"""The one traffic generator: reads a mix file of `esp_bench/traffic/` and
returns the requests of a run, as (due seconds after the window opens,
prompt length, output length) plus the prompt token ids.

The length laws are a frozen copy of `src/repro_torch/data/workload.py`
(commit d8ac532): a lognormal prompt length around a median, clipped to
[lo, hi], and a uniform output length.  A mix file gives the laws by
number, so a new mix is a new data file:

    {"kind": "open" | "backlog",
     "n": requests generated (an open mix submits those due in the window),
     "rate": requests per second of the Poisson arrivals (open only),
     "base_seed": fixes the sizes, their order and the arrival times,
     "mix": [{"name", "share", "prompt": {"median", "sigma", "lo", "hi"},
              "output": {"lo", "hi"}}, ...],
     "warmup": [[prompt, output], ...]   (set-up requests)}

Every seed serves one fixed schedule of sizes and arrival times; the
run's seed draws only the token ids (and the weights).  Reordering sizes
by seed moved the few long prompts of a window, and the tail with them,
from seed to seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Item:
    due: float  # seconds after the window opens
    prompt_len: int
    out_len: int


def _lengths(law: dict, n: int, rng, idx: int) -> List[tuple]:
    p, o = law["prompt"], law["output"]
    ln = rng.lognormal(math.log(p["median"]), p["sigma"], n)
    ln = np.clip(ln, p["lo"], p["hi"]).astype(np.int64)
    out = rng.integers(o["lo"], o["hi"] + 1, n)
    return [(int(a), int(b), idx) for a, b in zip(ln, out)]


def sizes(mix: dict) -> List[tuple]:
    """The multiset of (prompt, output, law index), in the base order: each
    law's share of the count (by rounding, the last law takes the rest),
    shuffled together by the base seed."""
    rng = np.random.default_rng(mix["base_seed"])
    n = int(mix["n"])
    out: List[tuple] = []
    for i, law in enumerate(mix["mix"]):
        k = n - len(out) if i == len(mix["mix"]) - 1 else round(law["share"] * n)
        out += _lengths(law, k, rng, i)
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def dues(mix: dict) -> np.ndarray:
    """Due times: Poisson arrivals at ``rate`` for an open mix (the first
    due at its first gap), all 0 for a backlog."""
    n = int(mix["n"])
    if mix["kind"] == "backlog":
        return np.zeros(n)
    rng = np.random.default_rng([mix["base_seed"], 1])
    return np.cumsum(rng.exponential(1.0 / float(mix["rate"]), n))


def items(mix: dict) -> List[Item]:
    """The mix's requests in due order."""
    return [Item(float(t), p, o) for t, (p, o, _) in zip(dues(mix), sizes(mix))]


def prompts(lengths: List[int], vocab: int, seed: int) -> List[list]:
    """Token ids of each prompt, drawn from `seed` in one call."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 3])
    flat = rng.integers(0, vocab, int(sum(lengths)))
    cut = np.cumsum([0] + list(lengths))
    return [flat[a:b].tolist() for a, b in zip(cut[:-1], cut[1:])]
