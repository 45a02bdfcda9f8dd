"""The generator is deterministic and seed-steady; the end-to-end
arithmetic agrees with hand counts; the frozen work counts agree with the
port's census at a tiny shape."""
import json
from pathlib import Path

import pytest

from esp_bench import stats, traffic
from esp_bench import workcount as wc

HERE = Path(__file__).resolve().parent


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["long_mixed_open", "chat_backlog"])
def test_traffic_deterministic_and_seed_steady(name):
    """One fixed schedule of sizes and due times, whatever the seed; the
    seed (a large one too) draws only the token ids."""
    mix = _mix(name)
    a = traffic.items(mix)
    assert a == traffic.items(json.loads(json.dumps(mix)))
    assert [it.due for it in a] == sorted(it.due for it in a)
    assert [(it.prompt_len, it.out_len) for it in a] == [
        (p, o) for p, o, _ in traffic.sizes(mix)]
    lens = [it.prompt_len for it in a[:5]]
    big = 2**31 + 7
    assert traffic.prompts(lens, 1000, big) == traffic.prompts(lens, 1000, big)
    assert traffic.prompts(lens, 1000, big) != traffic.prompts(lens, 1000, 6)
    assert [len(t) for t in traffic.prompts(lens, 1000, big)] == lens


def test_traffic_laws():
    mix = _mix("long_mixed_open")
    sizes = traffic.sizes(mix)
    long_ = [p for p, _, law in sizes if law == 1]
    assert len(sizes) == mix["n"]
    assert round(0.1 * mix["n"]) <= len(long_) <= round(0.1 * mix["n"]) + 3
    assert max(p for p, _, _ in sizes) <= 65536 and min(p for p, _, _ in sizes) >= 4
    assert all(16 <= o <= 512 for _, o, _ in sizes)
    d = traffic.dues(mix)
    assert (d[1:] > d[:-1]).all()
    assert abs(len(d) / d[-1] - mix["rate"]) < 0.3 * mix["rate"]
    assert not traffic.dues(_mix("chat_backlog")).any()


def test_percentile_hand_counts():
    assert stats.pct([], 95) is None
    assert stats.pct([3.0], 95) == 3.0
    v = list(range(1, 21))  # 20 values: the 95th by nearest rank is the 19th
    assert stats.pct(v, 95) == 19
    assert stats.pct(v, 50) == 10
    assert stats.pct(list(range(1, 101)), 95) == 95


def test_ttft_counts_a_stall():
    t0, t_end, t_close = 0.0, 10.0, 10.5
    reqs = [{"due": float(i), "first": i + 0.5} for i in range(10)]
    base = stats.pct(stats.ttft_waits(reqs, t0, t_end, t_close), 95)
    assert base == pytest.approx(0.5)
    stalled = reqs + [{"due": 2.0, "first": None}]  # never served: 8.5 s so far
    waits = stats.ttft_waits(stalled, t0, t_end, t_close)
    assert max(waits) == pytest.approx(8.5)
    assert stats.pct(waits, 95) == pytest.approx(8.5)
    late = reqs + [{"due": 11.0, "first": None}]  # due after the window: out
    assert len(stats.ttft_waits(late, t0, t_end, t_close)) == 10


def test_gaps_and_served_tokens():
    reqs = [{"prompt_len": 100, "prefilled": 1.0, "tokens": [1.0, 1.2, 1.5]},
            {"prompt_len": 50, "prefilled": 9.0, "tokens": [9.0, 12.0]}]
    assert sorted(stats.token_gaps(reqs, 0.0, 10.0)) == pytest.approx([0.2, 0.3])
    # the second request's prompt counts (prefilled at 9), its token at 12 not
    assert stats.served_split(reqs, 0.0, 10.0) == (100 + 50, 3 + 1)
    assert stats.served_tokens(reqs, 0.0, 10.0) == 100 + 3 + 50 + 1


def _tiny_cfg():
    return {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
            "d_head": 16, "d_ff": 96, "vocab_size": 128, "ffn_kind": "swiglu",
            "qkv_bias": True}


def test_work_counts_equal_the_census():
    """The frozen counts against `launch/census.py` around the port's own
    prefill of one prompt (its bucket's length, so no padding) and one
    decode step of two rows."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import init_params
    from repro_torch.launch import census
    from repro_torch.models import build_model

    c = _tiny_cfg()
    mc = ModelConfig(name="t", family="dense", dtype="float32", **c)
    model = build_model(mc, device="cpu")
    params = init_params(mc, torch.Generator().manual_seed(0), "cpu")
    n = 64
    toks = torch.randint(0, 128, (1, n))
    with census.Census() as cs:
        model.prefill(params, {"tokens": toks}, last_logit_only=True)
    r = cs.result()
    attn = r["kernels"]["K4"]["flops"]
    assert attn == pytest.approx(wc.prefill_attn_flops(c, n))
    assert r["flops"] == pytest.approx(wc.prefill_flops(c, [n]))
    _, cache = model.prefill(params, {"tokens": toks[:, :40].repeat(2, 1)})
    with census.Census() as cs:
        model.decode(params, toks[:, 0].repeat(2), cache)
    r = cs.result()
    own = wc.decode_attn_flops(c, [0, 0])  # each row against its own key
    assert r["kernels"]["K5"]["flops"] == pytest.approx(
        wc.decode_attn_flops(c, [40, 40]) - own)  # the 40 cached keys
    # the census counts the own key's q.k product but not its p.v (an
    # elementwise multiply in the port), so half of `own`
    assert r["flops"] == pytest.approx(wc.decode_flops(c, [40, 40]) - own / 2)


def test_census_cross_check_phase18():
    """PERF.md's phase-18 census of lwm-7b (4 of 32 layers) prefill at B 1
    x S 8192: 1.546214e13 FLOPs, products and attention."""
    lwm = {"n_layers": 4, "d_model": 4096, "n_heads": 32, "n_kv_heads": 32,
           "d_head": 128, "d_ff": 11008, "vocab_size": 32000, "ffn_kind": "swiglu"}
    assert wc.prefill_flops(lwm, [8192]) == pytest.approx(1.546214e13, rel=1e-6)


def test_roofline_bound():
    c = dict(_tiny_cfg(), d_model=4096, n_layers=40, n_heads=32, n_kv_heads=2,
             d_head=128, d_ff=13696, vocab_size=151552)
    f, b = wc.decode_flops(c, [1000] * 8), wc.decode_bytes(c, [1000] * 8)
    assert wc.bound_s(f, b) == pytest.approx(b / wc.PEAK_BYTES_S)  # decode: bytes
    assert wc.weight_bytes(c) > 2 * 8e9
