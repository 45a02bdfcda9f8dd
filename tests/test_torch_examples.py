"""The PyTorch port's examples (`examples/torch_*.py`), each run on the CPU
as a subprocess with ``--device cpu``: each exits 0 and prints what its
namesake in `examples/` prints — zero scaling-migration bytes, tokens equal
to the serial dense oracle, and compare_systems' four systems on the four
workloads.  The examples import only `repro_torch`."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).parent.parent
SYSTEMS = ("loongserve", "vllm-tp", "chunked", "pd-disagg")
WORKLOADS = ("sharegpt", "leval", "lveval", "mixed")


def _run(name, *args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], env=env, capture_output=True, text=True, timeout=timeout,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_quickstart():
    out = _run("torch_quickstart.py")
    assert "Scaling-migration bytes (ESP zero-overhead invariant): 0" in out
    assert "token parity: 8 requests == serial dense oracle" in out
    assert out.rstrip().endswith("OK")


def test_elastic_scaling_demo():
    out = _run("torch_elastic_scaling_demo.py")
    assert "OK — all requests finished despite the instance failure" in out
    assert "scaling_migration_bytes      0" in out
    assert "token parity: 7 requests == serial dense oracle" in out
    assert out.rstrip().endswith("OK — real-mode tokens survive the failure "
                                 "and the restore")


def test_compare_systems():
    out = _run("torch_compare_systems.py", "--n", "8")
    for ds in WORKLOADS:
        block = out.split(f"=== {ds} ")[1].split("\n===")[0]
        for name in SYSTEMS:
            line = next(l for l in block.splitlines()
                        if l.strip().startswith(name))
            assert "fin=8 " in line, line
            assert "e2e=" in line and "x better" in line, line


def test_esp_spmd_demo():
    out = _run("torch_esp_spmd_demo.py")
    assert "MeshExecutor on mesh {'data': 4, 'model': 2}; world 8 (gloo)" in out
    assert "write-through: 0 mirror slots re-uploaded" in out
    assert ("token parity: 6 requests x 4 tokens == serial dense oracle on "
            "each of 8 ranks") in out
    assert out.rstrip().endswith("OK")


def test_examples_refuse_without_cuda():
    """Without ``--device cpu`` an example needs a card and says so."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
        env=env, capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0
    assert "CUDA" in out.stderr
