"""BENCHMARK.json keeps to its limits, the harness finds everything by
name, and nothing of the JAX package is imported by the harness."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

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


def test_a_new_mix_and_cell_need_no_edit(tmp_path):
    """Adding a traffic file, a cell and an entry for a metric whose reader
    is there runs that cell (on the CPU, at the rehearsal's size) with no
    file of the harness edited: here an open-loop mix, as the deferred
    long-context cell would be, reporting `ttft_p95_s`."""
    shutil.copytree(HERE, tmp_path / "esp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    b = _bench()
    mix = json.loads((HERE / "traffic" / "long_mixed_open.json").read_text())
    mix.update(n=12, base_seed=7)
    (tmp_path / "esp_bench" / "traffic" / "tiny_open.json").write_text(json.dumps(mix))
    cell = "glm4-9b.tiny_open"
    b["workloads"].append({"name": cell, "config": "glm4-9b", "traffic": "tiny_open",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "ttft_p95_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "esp_bench/run.py", "--workload", cell,
         "--seed", "5", "--seconds", "4", "--trace", "0", "--rehearse-cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res["metrics"]) == {"setup_s", "ttft_p95_s"}
    assert 0 < res["metrics"]["ttft_p95_s"]["value"] < 4.5
    assert res["attempted"] >= 1 and res["correct"] is True
    assert list(res)[-1] == "check"


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
