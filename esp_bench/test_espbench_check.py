"""The comparison that decides ``correct``: the plain reference agrees
with the port, a sound run reads correct, and a run with the timed path
broken underneath reads not correct, for each fault a served cell can
have.  All on the CPU at the rehearsal's size."""
import argparse
import json

import numpy as np
import pytest
import torch

from esp_bench import run as bench_run
from esp_bench import weights
from esp_bench.reference.dense import logits_at

CELL = "glm4-9b.chat_backlog"


@pytest.mark.parametrize("config", ["glm4-9b", "qwen1.5-4b"])
def test_reference_matches_the_port_model(config):
    """Reference logits at every position equal the port's own forward on
    the benchmark's weights (f32, CPU): GQA 16 with half rotary (glm4),
    MHA with qkv bias (qwen)."""
    from esp_bench.drive import model_config
    from repro_torch.models import build_model

    cfg = json.loads((bench_run.BENCH / "configs" / f"{config}.json").read_text())
    cfg, _ = bench_run.rehearsal(cfg, {"mix": [], "n": 0})
    params = weights.draw(cfg, 3, "cpu")
    model = build_model(model_config(cfg), device="cpu")
    toks = torch.randint(0, cfg["vocab_size"], (1, 37), generator=torch.Generator().manual_seed(1))
    want, _ = model.prefill(params, {"tokens": toks})
    got = logits_at(cfg, params, toks[0], torch.arange(37), q_block=8, row_block=16)
    assert (got - want[0].float()).abs().max() < 1e-4


def _run(capsys, fault=None, cell=CELL, seed=11, control=False):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=6.0, trace=0,
                              rehearse_cpu=True, rate=None, control=control)
    torch.manual_seed(0)
    assert bench_run.run(args, fault=fault, guard=False) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_sound_run_reads_correct(capsys):
    res, err = _run(capsys)
    gap = res["check"]["logit_gap"]
    assert res["correct"] is True, res["check"]
    assert gap["value"] < 1e-3 and gap["sampled_tokens"] >= 20
    assert "esp_bench check logit_gap" in err.strip().splitlines()[-2]


def _state_unchanged(eng):
    """Each decode step's new KV never reaches the pools."""
    for pool in eng.pool.pools:
        pool.fill = lambda *a, **k: None


def _half_batch(eng):
    """The second half of each decode batch takes the first half's logits."""
    ex = eng.executor
    emit = ex._emit_decoded

    def half(g, logits, kvs):
        n = logits.shape[0]
        logits = logits.clone()
        logits[(n + 1) // 2:] = logits[:n - (n + 1) // 2]
        return emit(g, logits, kvs)
    ex._emit_decoded = half


def _no_exchange(eng):
    """The multi-master merge sees one instance's partial only."""
    impl = eng.executor._paged_impl
    begin = impl.begin_step
    impl.begin_step = lambda shards: begin(shards[:1])


def _token_altered(eng):
    """Every sampled token is the one after the argmax."""
    v = eng.cfg.vocab_size
    eng._sample_token = lambda logits=None: (int(np.argmax(logits)) + 1) % v


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _no_exchange,
                                   _token_altered], ids=lambda f: f.__name__[1:])
def test_a_broken_timed_path_reads_not_correct(capsys, fault):
    res, _ = _run(capsys, fault)
    gap = res["check"]["logit_gap"]
    assert res["correct"] is False, res["check"]
    assert gap["sampled_tokens"] >= 20 and gap["limit"] < gap["value"] < float("inf")
    card = json.loads((bench_run.BENCH / "configs" / "glm4-9b.json").read_text())
    assert gap["value"] > card["logit_gap_limit"]  # above the card's limit too


def test_the_control_separates(capsys):
    """The float8 control, put in the program's place, comes out not
    correct through the same decision; it reads under the faults, and the
    f32 program reads 0.0 (the card's readings and limits: PERF.md)."""
    res, err = _run(capsys, control=True)
    gap = res["check"]["logit_gap"]
    assert res["correct"] is False, res["check"]
    assert gap["of"] == "fp8" and gap["sampled_tokens"] >= 20
    assert gap["limit"] < gap["value"] < 1.0
    assert "esp_bench check logit_gap" in err.strip().splitlines()[-2]
