"""The port's dry run and op census (`repro_torch.launch.dryrun`,
`repro_torch.launch.census`), held to the JAX package's
`repro/launch/dryrun.py` and `repro/launch/hlo.py`.

  * `model_flops_estimate` and `estimate_hbm`'s transient equal the
    reference's for every assigned arch (and lwm-7b) x shape on both
    production meshes, as do `shape_applicable`'s skips;
  * the census counts per rank: the reference's census loop on a fake
    (4, 2) world gives the hand count, and one DTensor product counts its
    local work once;
  * every kernel reports its work by shape: the same on the CPU (the plain
    version runs, uncounted) and on meta, equal to the formula, never added
    to the plain version's own products;
  * a reduced dense prefill's non-attention product FLOPs equal the
    reference's `hlo_census` of the same step;
  * `run_cell` lays out an ESP ring prefill, a decode, a ZeRO-1 train step
    and a moe cell on the fake (16, 16) world, and the CLI writes ``--out``.

The reference's dry run sets a 512-device ``XLA_FLAGS`` when imported, so
the reference runs only in subprocesses here.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ASSIGNED, REGISTRY, SHAPES, reduced  # noqa: E402
from repro_torch.configs import get_config, shape_applicable  # noqa: E402
from repro_torch.launch import census as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, close_fake_world,  # noqa: E402
                                     fake_production_mesh)

ROOT = pathlib.Path(__file__).parent.parent
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref(code: str, timeout: float = 300) -> dict:
    """Run ``code`` in a fresh interpreter with the JAX package; it prints
    one JSON line last."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def _close_world():
    yield
    close_fake_world()


# ============================================================ estimates
REF_ESTIMATES = """
import json
from repro.launch import dryrun as D
from repro.configs import ASSIGNED, SHAPES, get_config, shape_applicable
class M:
    def __init__(self, shape):
        self.shape = shape
meshes = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
out = {}
for arch in list(ASSIGNED) + ["lwm-7b"]:
    cfg = get_config(arch)
    for sn, shape in SHAPES.items():
        ok, why = shape_applicable(cfg, shape)
        for mn, ms in meshes.items():
            h = D.estimate_hbm(cfg, shape, M(ms), 0, 0)
            out[f"{arch}|{sn}|{mn}"] = [D.model_flops_estimate(cfg, shape),
                                        h["transient_bytes"], ok, why]
print(json.dumps(out))
"""


def test_estimates_equal_the_reference():
    want = _ref(REF_ESTIMATES)
    n = 0
    for arch in list(ASSIGNED) + ["lwm-7b"]:
        cfg = get_config(arch)
        for sn, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            for mn, (ms, names) in MESHES.items():
                flops, transient, r_ok, r_why = want[f"{arch}|{sn}|{mn}"]
                h = D.estimate_hbm(cfg, shape, MeshShape(ms, names), 0, 0)
                assert D.model_flops_estimate(cfg, shape) == pytest.approx(
                    flops, rel=1e-12), (arch, sn)
                assert h["transient_bytes"] == pytest.approx(
                    transient, rel=1e-12), (arch, sn, mn)
                assert (ok, why) == (r_ok, r_why), (arch, sn)
                n += 1
    assert n == 11 * 4 * 2


def test_long_500k_skipped_for_full_attention():
    for arch in ASSIGNED:
        cfg = get_config(arch)
        r = D.run_cell(arch, "long_500k", verbose=False) \
            if cfg.has_full_attention else None
        if r is not None:
            ok, why = shape_applicable(cfg, SHAPES["long_500k"])
            assert r == {"arch": arch, "shape": "long_500k",
                         "status": "skipped", "why": why}


# ============================================================== census
@pytest.fixture
def fake_world_8():
    """A fake world of 8 ranks (this process is rank 0) and its (4, 2)
    CPU mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    close_fake_world()
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_census_flops_exact(fake_world_8):
    """The counterpart of `tests/test_esp_spmd.py::test_hlo_census_flops_exact`
    on a fake (4, 2) world: x [8, 64] split over "data", w [3, 64, 64]
    replicated, three layers of ``h = c @ w_l`` constrained to
    P("data", "model"), then ``h @ w_l.T``.

    The reference's GSPMD pushes the constraint back into the first product,
    so each of its ranks computes a [2, 32] block: 3 x 2 x (2 2 64 32) =
    49152 FLOPs.  DTensor runs that product with w replicated ([2, 64] x
    [64, 64], 16384 FLOPs) and slices afterwards; the second product is
    [2, 32] x [32, 64] (8192) and leaves a partial sum over "model".  So
    per rank: 3 x (16384 + 8192) = 73728 FLOPs.  Collectives: layers 2 and
    3 reduce-scatter the partial [2, 64] f32 over "model" (g 2: 1/2 x 512
    bytes each), and the final sum's scalar is all-reduced over "data"
    (2 x 3/4 x 4) and "model" (2 x 1/2 x 4): 512 + 10 bytes."""
    mesh = fake_world_8
    from torch.distributed.tensor import distribute_tensor

    def place(shape, spec):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 shlib.placements(mesh, spec, len(shape)),
                                 src_data_rank=None)

    x = place((8, 64), shlib.P("data", None))
    w = place((3, 64, 64), shlib.P())
    with C.Census() as c:
        y = x
        for layer in range(3):
            h = y @ w[layer]
            h = h.redistribute(mesh, shlib.placements(
                mesh, shlib.P("data", "model"), 2))
            y = h @ w[layer].T
        y.sum().full_tensor()
    r = c.result()
    assert r["flops"] == 3 * (2 * 2 * 64 * 64 + 2 * 2 * 32 * 64) == 73728
    assert r["reduce-scatter"] == 2 * (1 / 2) * (2 * 64 * 4)
    assert r["all-reduce"] == 2 * 3 / 4 * 4 + 2 * 1 / 2 * 4
    assert r["collective_bytes"] == 522
    assert r["kernels"] == {}


def test_dtensor_product_counted_once_per_rank():
    """One product on the fake 256-rank world: x [512, 32] split over
    ("data", "model") times a replicated [32, 32].  Each rank multiplies
    [2, 32] x [32, 32] = 4096 FLOPs; counting the DTensor-level op too
    would add the global 1,048,576 (`FlopCounterMode` does: 1,052,672)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = fake_production_mesh()
    x = distribute_tensor(torch.empty(512, 32, device="meta"), mesh,
                          shlib.placements(mesh, shlib.P(("data", "model")), 2),
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(32, 32, device="meta"), mesh,
                          shlib.placements(mesh, shlib.P(), 2),
                          src_data_rank=None)
    with C.Census() as c:
        y = x @ w
    assert y.to_local().shape == (2, 32)
    r = c.result()
    assert r["flops"] == 2 * 2 * 32 * 32 == 4096
    assert r["collective_bytes"] == 0


# ------------------------------------------------------------- kernels
def _counted(fn, *args):
    with C.Census() as c:
        fn(*args)
    return c.result()


def _k4_formula(b, sq, sk, h, d, kvh, causal, window, es, *, lse=False,
                o_f32=False):
    kk = sk if window is None else min(sk, window)
    pairs = b * sq * kk * (0.5 if causal else 1.0)
    q_b, kv_b = b * sq * h * d * es, 2 * b * sk * kvh * d * es
    o_b = b * sq * h * d * (4 if o_f32 else es)
    return 4 * h * d * pairs, (q_b + kv_b + 4 * (sq + sk) + o_b
                               + (4 * b * h * sq if lse else 0))


def _qkv(dev, b, sq, sk, h, kvh, d, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(0)
    mk = (lambda *s: torch.empty(s, dtype=dtype, device="meta")) \
        if dev == "meta" else \
        (lambda *s: torch.randn(*s, generator=g, dtype=torch.float32).to(dtype))
    q, k, v = mk(b, sq, h, d), mk(b, sk, kvh, d), mk(b, sk, kvh, d)
    if grad:
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    qp = torch.arange(sk - sq, sk, device=dev)
    kp = torch.arange(sk, device=dev)
    return q, k, v, qp, kp


@pytest.mark.parametrize("causal,window,dtype", [
    (True, None, torch.float32), (True, 16, torch.bfloat16),
    (False, None, torch.float32)])
def test_k4_work_by_shape(causal, window, dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels.striped_attention import striped_flash_attention

    b, sq, sk, h, kvh, d = 2, 24, 40, 4, 2, 16
    es = torch.finfo(dtype).bits // 8
    got = {}
    for dev in ("cpu", "meta"):
        q, k, v, qp, kp = _qkv(dev, b, sq, sk, h, kvh, d, dtype)
        fwd = _counted(lambda: striped_flash_attention(
            q, k, v, qp, kp, causal=causal, window=window))
        part = _counted(lambda: ops.attention_partial(
            q, k, v, qp, kp, causal=causal, window=window))
        got[dev] = (fwd, part)
    assert got["cpu"] == got["meta"]
    fwd, part = got["cpu"]
    flops, bytes_ = _k4_formula(b, sq, sk, h, d, kvh, causal, window, es)
    # the plain version's own products are not counted: only the kernel's
    assert fwd["kernels"] == {"K4": {"calls": 1, "flops": flops,
                                     "bytes": bytes_}}
    assert (fwd["flops"], fwd["bytes"]) == (flops, bytes_)
    flops, bytes_ = _k4_formula(b, sq, sk, h, d, kvh, causal, window, es,
                                lse=True, o_f32=True)
    assert part["kernels"] == {"K4": {"calls": 1, "flops": flops,
                                      "bytes": bytes_}}
    assert part["flops"] == flops  # the partial's conversion has no product


def test_k4_backward_work_by_shape():
    from repro_torch.kernels.striped_attention import striped_flash_attention

    b, sq, sk, h, kvh, d = 1, 32, 32, 4, 2, 8
    got = {}
    for dev in ("cpu", "meta"):
        q, k, v, qp, kp = _qkv(dev, b, sq, sk, h, kvh, d, grad=True)

        def step():
            o = striped_flash_attention(q, k, v, qp, kp, causal=True)
            torch.autograd.grad(o, (q, k, v), torch.ones_like(o))

        got[dev] = _counted(step)
    assert got["cpu"] == got["meta"]
    r = got["cpu"]
    pairs = b * sq * sk * 0.5
    es = 4
    q_b, kv_b, lse_b = b * sq * h * d * es, 2 * b * sk * kvh * d * es, 4 * b * h * sq
    assert r["kernels"]["K4"] == {
        "calls": 1, "flops": 4 * h * d * pairs,
        "bytes": q_b + kv_b + 4 * (sq + sk) + q_b + lse_b}
    # reads q, k, v, o, do, the LSE and the positions; writes dq, dk, dv
    assert r["kernels"]["K4 bwd"] == {
        "calls": 1, "flops": 10 * h * d * pairs,
        "bytes": 3 * q_b + kv_b + lse_b + 4 * (sq + sk) + q_b + kv_b}
    assert r["flops"] == 14 * h * d * pairs


@pytest.mark.parametrize("window", [None, 24])
def test_k5_work_by_shape(window):
    from repro_torch.kernels import ops

    b, s, h, kvh, d = 3, 40, 4, 2, 16
    got = {}
    for dev in ("cpu", "meta"):
        q, k, v, _, _ = _qkv(dev, b, 1, s, h, kvh, d)
        lengths = torch.tensor([40, 17, 1], device=dev)
        got[dev] = _counted(lambda: ops.decode_partial(q, k, v, lengths,
                                                       window=window))
    assert got["cpu"] == got["meta"]
    kk = s if window is None else min(s, window)
    flops = 4 * h * d * b * kk
    bytes_ = 4 * (b * h * d + 2 * b * s * kvh * d) + 4 * b + 4 * b * h * (d + 2)
    assert got["cpu"]["kernels"] == {"K5": {"calls": 1, "flops": flops,
                                            "bytes": bytes_}}
    assert (got["cpu"]["flops"], got["cpu"]["bytes"]) == (flops, bytes_)


def test_k1_k2_k3_work_by_shape():
    """K1-K3 are not on the mesh-aware steps' path (no meta route): their
    CPU calls report the formula and nothing else."""
    from repro_torch.kernels import ops

    t, h, kvh, d = 48, 4, 2, 8
    g = torch.Generator().manual_seed(1)
    q = torch.randn(t, h, d, generator=g)
    k, v = torch.randn(t, kvh, d, generator=g), torch.randn(t, kvh, d, generator=g)
    off = np.array([0, 20, 48])
    pairs = t * t * 0.5
    r = _counted(lambda: ops.prefill_packed(q, k, v, off))
    io = 4 * (t * h * d + 2 * t * kvh * d) + 8 * 3
    assert r["kernels"] == {"K1": {"calls": 1, "flops": 4 * h * d * pairs,
                                   "bytes": io + 4 * t * h * d}}
    assert (r["flops"], r["bytes"]) == (4 * h * d * pairs, io + 4 * t * h * d)
    r = _counted(lambda: ops.prefill_ring_chunk(
        q, k, v, off, off, None, q_shard=0, k_shard=0, n_shards=1))
    assert r["kernels"] == {"K3": {"calls": 1, "flops": 4 * h * d * pairs,
                                   "bytes": io + 4 * t * h * (d + 2)}}
    assert r["flops"] == 4 * h * d * pairs

    b, page, n_pages, mp = 2, 16, 6, 3
    qd = torch.randn(b, 1, h, d, generator=g)
    kp_, vp_ = (torch.randn(n_pages, page, kvh, d, generator=g) for _ in "kv")
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]])
    r = _counted(lambda: ops.paged_decode_partial(
        qd, kp_, vp_, bt, torch.tensor([40, 9])))
    flops = 4 * h * d * b * mp * page
    bytes_ = (4 * b * h * d + 2 * b * mp * page * kvh * d * 4 + 4 * b * mp
              + 4 * b + 4 * b * h * (d + 2))
    assert r["kernels"] == {"K2": {"calls": 1, "flops": flops,
                                   "bytes": bytes_}}
    assert r["flops"] == flops


def test_collective_scaling():
    """The port's counted collectives scale as `hlo.py` scales its ops."""
    with C.Census() as c:
        C.report_collective("all-reduce", 800, 4)
        C.report_collective("all-gather", 100, 4)
        C.report_collective("reduce-scatter", 400, 4)
        C.report_collective("collective-permute", 64, 16)
    r = c.result()
    assert r["all-reduce"] == 2 * 3 / 4 * 800
    assert r["all-gather"] == 3 / 4 * (4 * 100)
    assert r["reduce-scatter"] == 3 / 4 * 400
    assert r["collective-permute"] == 64
    C.report_collective("all-reduce", 800, 4)  # no census open: dropped
    assert c.result() == r
    cc = C.collective_census(c)  # `hlo.collective_census`'s keys
    assert cc["total_bytes"] == r["collective_bytes"]
    assert set(cc) == set(C.COLLECTIVES) | {"total_bytes", "flops", "bytes"}


# ------------------------------------------- against the reference's HLO
REF_PREFILL = """
import json
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import REGISTRY, reduced
from repro.launch import steps
from repro.launch.hlo import hlo_census
cfg = reduced(REGISTRY["lwm-7b"])
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
model, step = steps.make_prefill_step(cfg, mesh, esp=False)
params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
pos = jax.ShapeDtypeStruct((S,), jnp.int32)
with mesh:
    hlo = jax.jit(step).lower(batch, pos, params).compile().as_text()
print(json.dumps(hlo_census(hlo)))
"""


def test_reduced_prefill_products_equal_the_reference():
    """Reduced lwm-7b, B 2 x S 64, at one rank: the port's census of its
    prefill step against the reference's `hlo_census` of the same step
    (compiled on a (1, 1) ``AxisType.Auto`` mesh).

    The non-attention products are equal but for one term: the reference
    picks the last position by a masked reduction over S (a dot, 2 B S d
    FLOPs), the port by an index.  Attention differs by design: XLA
    multiplies the whole [S, S] score matrix, 4 B H S^2 D per layer, where
    K4 counts the causal pairs, half of that."""
    b, s = 2, 64
    want = _ref(f"B, S = {b}, {s}\n" + REF_PREFILL)
    from repro_torch.convert import init_params
    from repro_torch.launch import steps

    cfg = reduced(REGISTRY["lwm-7b"])
    model, step = steps.make_prefill_step(cfg, None, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.zeros((b, s), dtype=torch.int32)
    with C.Census() as c:
        step({"tokens": tok}, torch.arange(s, dtype=torch.int32), params)
    r = c.result()
    h, d, n_layers = cfg.n_heads, cfg.head_dim, cfg.n_layers
    full_attn = n_layers * 4 * b * h * s * s * d
    assert r["kernels"]["K4"]["flops"] == full_attn / 2
    port_rest = r["flops"] - r["kernels"]["K4"]["flops"]
    ref_rest = want["flops"] - full_attn
    assert ref_rest - port_rest == 2 * b * s * cfg.d_model


# ============================================================ run_cell
def _ok(r):
    assert r["status"] == "ok", r.get("traceback", r)
    assert r["mesh"] == {"data": 16, "model": 16} and r["chips"] == 256
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_total", "useful_flops_ratio"):
        assert key in r["roofline"], key
    assert set(r["hbm_model"]) == {"resident_bytes", "transient_bytes",
                                   "peak_bytes", "fits_hbm"}
    m = r["memory"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] is not None
    assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] \
        + m["temp_bytes"]
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes_accessed"] > 0
    return r


def test_run_cell_esp_ring_prefill():
    r = _ok(D.run_cell("whisper-tiny", "prefill_32k", verbose=False))
    cfg = get_config("whisper-tiny")
    # one K4 (with its LSE) per ring step: 16 steps per decoder layer
    assert r["kernels"]["K4"]["calls"] == cfg.n_layers * 16
    assert r["collectives"]["collective-permute"] > 0  # the ring's legs


def test_run_cell_decode_and_options():
    r = _ok(D.run_cell("whisper-tiny", "decode_32k", verbose=False))
    cfg = get_config("whisper-tiny")
    assert r["kernels"]["K5"]["calls"] == cfg.n_layers
    adj = _ok(D.run_cell("whisper-tiny", "decode_32k", verbose=False,
                         options={"kernel_adjusted": True}))
    # the plain one-key partials' bytes drop; FLOPs and collectives stay
    assert adj["cost"]["bytes_accessed"] < r["cost"]["bytes_accessed"]
    assert adj["cost"]["flops"] == r["cost"]["flops"]
    assert adj["collectives"] == r["collectives"]
    # the multi-pod world replaces the single-pod one, and back
    mp = D.run_cell("whisper-tiny", "decode_32k", multi_pod=True,
                    verbose=False)
    assert mp["status"] == "ok", mp.get("traceback")
    assert mp["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert mp["chips"] == 512 and dist.get_world_size() == 512
    again = _ok(D.run_cell("whisper-tiny", "decode_32k", verbose=False))
    assert again["cost"] == r["cost"] and dist.get_world_size() == 256


def test_run_cell_zero1_train():
    r = _ok(D.run_cell("whisper-tiny", "train_4k", verbose=False))
    assert r["kernels"]["K4"]["calls"] > 0
    assert r["kernels"]["K4 bwd"]["calls"] > 0
    # ZeRO-1: gradients reduce-scattered into the moments' layout, the
    # parameters all-gathered back
    assert r["collectives"]["reduce-scatter"] > 0
    assert r["collectives"]["all-gather"] > 0
    assert 0 < r["roofline"]["useful_flops_ratio"] < 2


def test_run_cell_moe():
    r = _ok(D.run_cell("mixtral-8x7b", "decode_32k", verbose=False))
    cfg = get_config("mixtral-8x7b")
    assert r["kernels"]["K5"]["calls"] == cfg.n_layers


def test_cli_writes_out(tmp_path):
    out = tmp_path / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert re.search(
        r"^\[whisper-tiny × decode_32k × 256\] OK compute=[\d.]+ms "
        r"memory=[\d.]+ms collective=[\d.]+ms dominant=\w+ "
        r"peak_mem=[\d.]+GiB useful=[\d.]+$", p.stdout, re.M), p.stdout
    assert "cells: 1  ok: 1 skipped: 0  errors: 0" in p.stdout
    cells = json.loads(out.read_text())
    assert [c["status"] for c in cells] == ["ok"]
