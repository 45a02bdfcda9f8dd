"""The dense family reads exactly what it read before its reference was
found by name (`esp_bench/lookup.py`): glm4-9b's weights, work counts and
reference logits, pinned as the harness gave them when the dense model,
its weight tree and its counts were wired in.  Each tensor is pinned
bit for bit by a hash, after a few values that show where a drift lies
(float32 on one CPU thread)."""
import hashlib
import json

import pytest
import torch

from esp_bench import lookup, weights
from esp_bench import run as bench_run
from esp_bench import workcount as wc
from esp_bench.reference import dense

CTX = [0, 5, 1000, 2299, 40000]
LENS = [4, 320, 2300]
WEIGHTS = {  # seed: (leaves, sum, largest magnitude, hash)
    1: (15, 10236.711094735158, 1.3890135288238525,
        "45d0126e307df1e35383079de2bb5705a437a81d3d21ab4d77d4b0b8500a12fa"),
    2**31 + 7: (15, 10292.131201539392, 1.4197275638580322,
                "ed4ea41f0257120a28122fbcfc087611c9c3969fb1faebd6224c06f27ae572bc"),
}
COUNTS = {
    "decode_flops": 116169768960.0,
    "decode_bytes": 19335602176.0,
    "decode_attn_bytes": 1777213440.0,
    "decode_attn_flops": 28382986240.0,
    "prefill_flops": 44583482294272.0,
}
LOGITS = {  # lowp: (each row's first choice, sum, max, hash)
    None: ([318, 157, 501, 412, 364, 245, 24, 245, 252, 252, 342, 409, 392, 301,
            301, 252, 176, 329, 32, 176, 342, 40, 501, 366, 223, 198, 198, 245,
            364, 409, 372, 159, 301], 229.36323787504807, 3.4223790168762207,
           "947b1ce6c01328fe93d063f4c5bd0e520b2ea789226046764fecafc72d283e65"),
    "fp8": ([318, 157, 501, 412, 364, 366, 24, 245, 252, 252, 409, 223, 392, 301,
             301, 252, 176, 329, 409, 176, 342, 301, 501, 366, 223, 198, 198, 245,
             364, 409, 324, 159, 301], 224.66357363644056, 3.511066198348999,
            "c8079aab542fd6f7767db11d75a7a7a04cba4c88de25318d2437790ce3893fed"),
}


def _cfg():
    return json.loads((bench_run.BENCH / "configs" / "glm4-9b.json").read_text())


def _rehearsal_cfg():
    cfg, _ = bench_run.rehearsal(_cfg(), {"mix": [], "n": 0})
    return cfg


def _leaves(node, path=()):
    for k in sorted(node):
        v = node[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _tree_hash(tree) -> str:
    h = hashlib.sha256()
    for path, v in _leaves(tree):
        h.update((path + str(tuple(v.shape))).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_dense_configurations_find_the_dense_reference():
    assert lookup.reference(_cfg()) is dense
    assert lookup.reference({"name": "hand-made"}) is dense


@pytest.mark.parametrize("seed", sorted(WEIGHTS))
def test_dense_weights_pinned(seed):
    n, total, top, digest = WEIGHTS[seed]
    tree = weights.draw(_rehearsal_cfg(), seed, "cpu")
    leaves = [v for _, v in _leaves(tree)]
    assert len(leaves) == n
    assert sum(float(v.double().sum()) for v in leaves) == pytest.approx(total, rel=1e-6)
    assert max(float(v.abs().max()) for v in leaves) == pytest.approx(top, rel=1e-6)
    assert _tree_hash(tree) == digest


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_dense_work_counts_pinned(name):
    arg = LENS if name.startswith("prefill") else CTX
    assert getattr(wc, name)(_cfg(), arg) == COUNTS[name]


@pytest.mark.parametrize("lowp", sorted(LOGITS, key=str), ids=str)
def test_dense_reference_logits_pinned(lowp):
    """On one thread, as the tests run: the sums' order is then fixed."""
    torch.set_num_threads(1)
    cfg = _rehearsal_cfg()
    params = weights.draw(cfg, 3, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (53,),
                         generator=torch.Generator().manual_seed(1))
    got = dense.logits_at(cfg, params, toks, torch.arange(20, 53), lowp=lowp,
                          q_block=16, row_block=32)
    first, total, top, digest = LOGITS[lowp]
    assert got.argmax(-1).tolist() == first
    assert float(got.double().sum()) == pytest.approx(total, rel=1e-6)
    assert float(got.max()) == pytest.approx(top, rel=1e-6)
    assert hashlib.sha256(got.contiguous().numpy().tobytes()).hexdigest() == digest
