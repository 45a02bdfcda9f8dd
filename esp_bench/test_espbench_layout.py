"""BENCHMARK.json keeps to its limits, the harness finds everything by
name, and nothing of the JAX package is imported by the harness."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from esp_bench import lookup
from esp_bench import workcount as wc

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_lines():
    b = _bench()
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in metrics + b["workloads"] + b["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_and_moves_are_reported():
    from esp_bench import run as bench_run

    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m
        for c in m.get("workloads", cells):
            assert c in cells and c in e2e[m["moves"]], (m["name"], c)
    for c in cells:
        got = [n for n, ws in e2e.items() if c in ws]
        assert "setup_s" in got and len(got) >= 2, c
        assert any(c in m.get("workloads", cells) for m in b["per_layer"]), c
    for m in b["end_to_end"] + b["per_layer"]:
        assert bench_run.reader_path(m["name"]).is_file(), m["name"]
    for w in b["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_and_a_plain_reference():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        bad = {m for m in _imports(f) if m in ("jax", "jaxlib", "flax", "repro")}
        assert not bad, (f, bad)
    for f in sorted((HERE / "reference").rglob("*.py")):
        mods = set(_imports(f))
        assert "repro_torch" not in mods, f
        assert mods <= {"__future__", "math", "typing", "torch"}, (f, mods)


def _harness_copy(tmp_path):
    """The harness and the port beside it in `tmp_path`, and a snapshot of
    every file of the harness copy, to show that none was edited."""
    shutil.copytree(HERE, tmp_path / "esp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    return {f: f.read_bytes() for f in (tmp_path / "esp_bench").rglob("*")
            if f.is_file() and "__pycache__" not in f.parts}


def _tiny_open(tmp_path):
    """A 12-request open mix in the harness copy."""
    mix = json.loads((HERE / "traffic" / "long_mixed_open.json").read_text())
    mix.update(n=12, base_seed=7)
    (tmp_path / "esp_bench" / "traffic" / "tiny_open.json").write_text(json.dumps(mix))


def _rehearse(tmp_path, cell, seconds, prog=("esp_bench/run.py",)):
    """The benchmark's command on the CPU, as a checkout runs it."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, *prog, "--workload", cell,
         "--seed", "5", "--seconds", str(seconds), "--trace", "0", "--rehearse-cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_new_mix_and_cell_need_no_edit(tmp_path):
    """Adding a traffic file, a cell and an entry for a metric whose reader
    is there runs that cell (on the CPU, at the rehearsal's size) with no
    file of the harness edited: here an open-loop mix, as the deferred
    long-context cell would be, reporting `ttft_p95_s`."""
    _harness_copy(tmp_path)
    _tiny_open(tmp_path)
    b = _bench()
    cell = "glm4-9b.tiny_open"
    b["workloads"].append({"name": cell, "config": "glm4-9b", "traffic": "tiny_open",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "ttft_p95_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    res = _rehearse(tmp_path, cell, 4)
    assert set(res["metrics"]) == {"setup_s", "ttft_p95_s"}
    assert 0 < res["metrics"]["ttft_p95_s"]["value"] < 4.5
    assert res["attempted"] >= 1 and res["correct"] is True
    assert list(res)[-1] == "check"


TOY = '''"""A family that serves as the dense one with its logits of token
0 raised by SHIFT, one leaf of its own in its weight tree, its own key
shrunk for the rehearsal, and its own decode counts."""
from __future__ import annotations

from .dense import logits_at as dense_logits_at
from .dense import shapes as dense_shapes

SHIFT = {shift}


def logits_at(cfg, params, tokens, rows, **kw):
    out = dense_logits_at(cfg, params, tokens, rows, **kw)
    out[:, 0] += SHIFT
    return out


def shapes(cfg):
    w, n, b = dense_shapes(cfg)
    return w, n, b + [(("toy", "bias"), (3,))]


def rehearse(cfg):
    return dict(cfg, d_ff=384)


def decode_attn_flops(cfg, ctx):
    return 5.0 * sum(ctx)


def decode_attn_bytes(cfg, ctx):
    return 11.0 * len(ctx)


def decode_flops(cfg, ctx):
    return 7.0 * len(ctx) + decode_attn_flops(cfg, ctx)


def decode_bytes(cfg, ctx):
    return 13.0 + decode_attn_bytes(cfg, ctx)
'''

# The port knows no family `toy`, so the toy configuration keeps glm4-9b's
# `family`, and this wrapper has the lookup give it the toy module, as it
# gives a configuration of family `toy`.  It probes the counts, the shrink
# and the weight tree through the harness, then runs the cell.
TOY_RUN = """
import importlib, json, sys
from esp_bench import lookup

by_family = lookup.reference


def reference(cfg):
    if cfg.get("name") != "toy":
        return by_family(cfg)
    mod = importlib.import_module("esp_bench.reference.toy")
    lookup.validate(mod)
    return mod


lookup.reference = reference
from esp_bench import run, weights, workcount as wc

cfg = json.load(open("esp_bench/configs/toy.json"))
small, _ = run.rehearsal(cfg, {"mix": [], "n": 0})
json.dump({"decode_flops": wc.decode_flops(cfg, [3, 4]),
           "decode_bytes": wc.decode_bytes(cfg, [3, 4]),
           "prefill_flops": wc.prefill_flops(cfg, [5, 9]),
           "d_ff": small["d_ff"],
           "toy_leaf": list(weights.draw(small, 1, "cpu")["toy"]["bias"].shape)},
          open("probe.json", "w"))
sys.exit(run.main(sys.argv[1:]))
"""


def _toy(tmp_path, shift: float):
    """A reference `toy`, a configuration `toy` (glm4-9b's keys) and a cell
    `toy.tiny_open`, added to a copy of the harness."""
    snap = _harness_copy(tmp_path)
    _tiny_open(tmp_path)
    h = tmp_path / "esp_bench"
    (h / "reference" / "toy.py").write_text(TOY.format(shift=shift))
    cfg = json.loads((h / "configs" / "glm4-9b.json").read_text())
    cfg.update(name="toy")
    (h / "configs" / "toy.json").write_text(json.dumps(cfg))
    b = _bench()
    b["configs"].append(dict(b["configs"][0], name="toy",
                             file="esp_bench/configs/toy.json"))
    b["workloads"].append({"name": "toy.tiny_open", "config": "toy",
                           "traffic": "tiny_open", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "ttft_p95_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["toy.tiny_open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return snap


@pytest.mark.parametrize("shift,correct", [(0.0, True), (8.0, False)],
                         ids=["agrees", "disagrees"])
def test_a_new_reference_needs_no_edit(tmp_path, shift, correct):
    """A reference file, a configuration and a cell run with no file of the
    harness edited: `correct` is decided by that reference (the toy that
    favours token 0 by 8 reads not correct), the port gets the toy's weight
    tree, the rehearsal takes the toy's shrink and `workcount` the toy's
    decode counts (its prefill counts, which it leaves out, are dense)."""
    snap = _toy(tmp_path, shift)
    res = _rehearse(tmp_path, "toy.tiny_open", 4, prog=("-c", TOY_RUN))
    gap = res["check"]["logit_gap"]
    assert res["correct"] is correct, res["check"]
    assert gap["sampled_tokens"] >= 8
    assert gap["value"] > 1.0 if shift else gap["value"] < 1e-3
    probe = json.loads((tmp_path / "probe.json").read_text())
    glm4 = json.loads((HERE / "configs" / "glm4-9b.json").read_text())
    assert probe == {"decode_flops": 7.0 * 2 + 5.0 * 7, "decode_bytes": 13.0 + 22.0,
                     "prefill_flops": wc.prefill_flops(glm4, [5, 9]),
                     "d_ff": 384, "toy_leaf": [3]}
    assert snap == {f: f.read_bytes() for f in snap}


def _stub(left_out=()):
    """A reference module's names, less `left_out`."""
    names = ("logits_at", "shapes") + sum(lookup.COUNTS, ())
    return types.SimpleNamespace(__name__="stub", **{
        n: (lambda *a: 0.0) for n in names if n not in left_out})


def test_a_reference_states_whole_groups_of_counts():
    lookup.validate(_stub())
    lookup.validate(_stub(lookup.COUNTS[0]))
    lookup.validate(_stub(sum(lookup.COUNTS, ())))


@pytest.mark.parametrize("left_out", ("logits_at", "shapes") + sum(lookup.COUNTS, ()))
def test_a_reference_missing_a_part_is_refused(left_out):
    """Without its model, its weight tree, or one count of a group that it
    states, a module is refused: a dense count beside a family's own would
    misstate its work."""
    with pytest.raises(TypeError, match=left_out):
        lookup.validate(_stub((left_out,)))


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    """Without a card the command exits non-zero and prints no result; in a
    directory holding only BENCHMARK.json and the harness as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "esp_bench/run.py", "--workload",
           "glm4-9b.chat_backlog", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copytree(HERE, tmp_path / "esp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(cmd + ["--rehearse-cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    """`repro` and `jax.numpy` are caught, `repro_torch` is not."""
    import types

    from esp_bench import run as bench_run

    for name in ("repro_torch.x", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in bench_run.forbidden_modules()
                if m.startswith(("repro_torch", "jaxtyping_like"))]
    for name in ("repro", "repro.engine", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"repro", "repro.engine", "jax.numpy"} <= set(bench_run.forbidden_modules())
