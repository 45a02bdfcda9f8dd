"""The slice as a whole: the port's real-mode LoongServeEngine (4 elastic
instances, reduced lwm-7b, parameters converted from the JAX `Model.init`
pytree) serves a workload whose arrivals give both DoP=1 and DoP>1 packed
prefill batches, then multi-master paged decode.  Every request's greedy
tokens must equal the JAX reference's `serial_decode_oracle` exactly, ESP
scale-down must move zero bytes, and the dispatch counters must show K1,
K3 and K2 on the path and no serial prefill.

Two guards: importing every `repro_torch` module loads neither `jax` nor
the reference package, and a default-device entry point that computes
raises where there is no CUDA device.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import init_params, params_from_numpy  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# prompt lengths and arrival times: the first arrival finds all 4 instances
# idle (a DoP=4 ring prefill); later ones land while decode groups hold
# instances, so DoP=1 batches occur too
LENS = [100, 20, 60, 8, 90, 33]
ARRIVALS = [0.0, 0.0005, 0.001, 0.002, 0.003, 0.004]
NEW_TOKENS = 4


def test_engine_matches_jax_serial_oracle():
    jcfg = reduced(REGISTRY["lwm-7b"], n_layers=2)
    tcfg = t_reduced(T_REGISTRY["lwm-7b"], n_layers=2)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    eng = LoongServeEngine(tcfg, 4, 1024, store_values=True,
                           model=build_model(tcfg, device="cpu"),
                           params=params, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(input_len=n, max_new_tokens=NEW_TOKENS, arrival=t,
                    prompt=rng.integers(0, tcfg.vocab_size, n).tolist())
            for n, t in zip(LENS, ARRIVALS)]
    ops.reset_dispatch_counts()
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    assert m.scaling_migration_bytes == 0
    assert ops.dispatch_counts["prefill_packed"] > 0  # DoP=1 batches (K1)
    assert ops.dispatch_counts["prefill_ring_chunk"] > 0  # DoP>1 rings (K3)
    assert ops.dispatch_counts["paged_decode_partial"] > 0  # decode (K2)
    assert ops.dispatch_counts.get("prefill_serial_model", 0) == 0
    for r in reqs:
        assert len(r.output_tokens) == NEW_TOKENS
        want = jref.serial_decode_oracle(jmodel, jparams, r.prompt,
                                         NEW_TOKENS - 1)
        assert r.output_tokens == want, (r.rid, r.output_tokens, want)


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(mods) >= 30, mods\n"
        "assert 'repro_torch.launch.mesh' in mods, mods\n"
        "assert 'repro_torch.launch.steps' in mods, mods\n"
        "assert 'repro_torch.launch.train' in mods, mods\n"
        "assert 'repro_torch.launch.sharding' in mods, mods\n"
        "assert 'repro_torch.core.ssm_sp' in mods, mods\n"
        "assert 'repro_torch.launch.dryrun' in mods, mods\n"
        "assert 'repro_torch.launch.census' in mods, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_reduced(T_REGISTRY["lwm-7b"], n_layers=1)
    # a sim-mode engine holds no tensors and resolves no device
    assert LoongServeEngine(cfg, 2, 64).device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LoongServeEngine(cfg, 2, 64, store_values=True, model=model,
                         params=init_params(cfg, torch.Generator(), "cpu"))


def test_mesh_executor_is_not_ported(tmp_path):
    """``executor="mesh"`` builds the port's `MeshExecutor` (no "not
    ported" error any more): on a one-rank gloo world the mesh has one data
    coordinate, every instance aliases onto it and the executor replays in
    process, giving the local executor's tokens.  Multi-rank worlds are
    tests/test_torch_mesh.py's."""
    import torch.distributed as dist

    from repro_torch.engine.executor import MeshExecutor
    from repro_torch.launch.mesh import init_process_group, make_test_mesh

    cfg = t_reduced(T_REGISTRY["lwm-7b"], n_layers=1)
    model = build_model(cfg, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init_process_group("cpu", init_method=f"file://{tmp_path / 'rdv'}",
                       world_size=1, rank=0)
    try:
        out = []
        for kw in ({"executor": "mesh"},
                   {"mesh": make_test_mesh(1, 1, device="cpu")}, {}):
            eng = LoongServeEngine(cfg, 2, 256, store_values=True,
                                   model=model, params=params, device="cpu",
                                   **kw)
            assert isinstance(eng.executor, MeshExecutor) == bool(kw)
            rng = np.random.default_rng(4)
            reqs = [Request(input_len=n, max_new_tokens=3, arrival=0.0,
                            prompt=rng.integers(0, 256, n).tolist())
                    for n in (40, 9, 23)]
            for r in reqs:
                eng.submit(r)
            assert len(eng.run().finished) == len(reqs)
            out.append([r.output_tokens for r in reqs])
        assert out[0] == out[1] == out[2]
    finally:
        dist.destroy_process_group()


def test_jax_oracle_agrees_with_port_oracle():
    """The port's own serial oracle (used on the card) gives the JAX
    oracle's tokens on converted parameters."""
    from repro_torch.kernels import ref as tref

    jcfg = reduced(REGISTRY["glm4-9b"], n_layers=1)
    tcfg = t_reduced(T_REGISTRY["glm4-9b"], n_layers=1)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    params = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 23).tolist()
    want = jref.serial_decode_oracle(jmodel, jparams, prompt, 3)
    got = tref.serial_decode_oracle(build_model(tcfg, device="cpu"), params,
                                    prompt, 3)
    assert got == want
