"""Rank bodies of `tests/test_torch_mesh.py`: the port's mesh executor and
SPMD programs across spawned processes on gloo.

This module imports only `repro_torch` (and torch / numpy): the spawned
ranks never load JAX or the reference package.  The test process computes
the JAX expectations and hands every rank the same numpy inputs; each rank
returns numpy results, which the test holds against the expectations and
against the other ranks'.

`spawn(world, cases, payload, tmp)` runs ``world`` ranks, each opening a
gloo group through a ``file://`` rendezvous under ``tmp`` (no fixed port,
so parallel test workers never collide), and running ``cases`` (names in
`CASES`) in order.  It returns ``[rank 0 results, rank 1 results, ...]``
and raises with the rank's traceback if any rank fails, or when the world
does not finish within its time limit (a hung collective).
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import numpy as np

NEW_TOKENS = 4


# ------------------------------------------------------------------ parent
def spawn(world: int, cases, payload, tmp, timeout: float = 240.0,
          module: str = __name__):
    """``module`` names the module whose `CASES` the ranks run."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.join(str(tmp), f"rdv_{world}_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, list(cases), payload, q,
                               module))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world {world} did not finish {list(cases)} within "
                    f"{timeout:.0f} s ({len(results)} ranks done)"
                )
            try:
                rank, res, err = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and not errors:
                    # a rank died without reporting: stop waiting for it
                    codes = [p.exitcode for p in procs]
                    raise RuntimeError(f"a rank exited early: {codes}")
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10.0 if not errors else 1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


def _rank_main(rank, world, init, cases, payload, q, module=__name__):
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import init_process_group

        init_process_group("cpu", init_method=f"file://{init}",
                           world_size=world, rank=rank, timeout_s=180.0)
        out = {}
        registry = importlib.import_module(module).CASES
        for name in cases:
            out[name] = registry[name](rank, world, payload)
        q.put((rank, out, None))
    except BaseException:  # report every failure to the parent, then exit
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------ helpers
def _tensors(*xs):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _mesh(data, model):
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(data=data, model=model, device="cpu")


def _model(payload):
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model

    cfg = reduced(REGISTRY["lwm-7b"], n_layers=payload["n_layers"])
    return cfg, build_model(cfg, device="cpu"), params_from_numpy(
        cfg, payload["params"], device="cpu")


def _engine(payload, n_inst, mesh, capacity=4000, **kw):
    from repro_torch.engine.server import LoongServeEngine

    cfg, model, params = _model(payload)
    return LoongServeEngine(cfg, n_inst, capacity, store_values=True,
                            model=model, params=params, page_size=16,
                            mesh=mesh, device="cpu", **kw)


def prefill_batch(eng, rng, lengths, rid0=0, max_new=NEW_TOKENS):
    """The reference test's directly-built prefill batch over every
    instance (`tests/mesh_exec_cases.py::_prefill_batch`)."""
    from repro_torch.engine.request import Phase, Request
    from repro_torch.manager.scheduler import PrefillBatch

    n_inst = len(eng.pool.pools)
    reqs, placement = [], {}
    for j, ln in enumerate(lengths):
        n = int(ln)
        r = Request(input_len=n, max_new_tokens=max_new,
                    prompt=rng.integers(0, eng.cfg.vocab_size, n).tolist())
        r.rid, r.phase = rid0 + j, Phase.PREFILL
        eng._req_index[r.rid] = r
        plan = eng.pool.plan_placement(r.rid, list(range(n)), range(n_inst))
        eng.pool.place(plan)
        placement[r.rid] = plan.assignment
        reqs.append(r)
    return PrefillBatch(reqs, list(range(n_inst)),
                        scale_down_to=list(range(n_inst)),
                        placement=placement)


def _counts():
    from repro_torch.kernels import ops

    return dict(ops.dispatch_counts), dict(ops.comm_bytes)


# ------------------------------------------------------------------- cases
def case_ring(rank, world, payload):
    """`ring_packed_prefill_spmd` on every mesh shape this world holds, for
    {GQA, window 7, softcap 5} x double_buffer {T, F}."""
    from repro_torch.core import esp
    from repro_torch.kernels import ops

    q, k, v = _tensors(payload["q"], payload["k"], payload["v"])
    off = payload["off"]
    out = {}
    for data, model in payload["ring_meshes"][world]:
        mesh = _mesh(data, model)
        for window, softcap in payload["variants"]:
            for db in (True, False):
                ops.reset_dispatch_counts()
                o = esp.ring_packed_prefill_spmd(
                    mesh, q, k, v, off, window=window, softcap=softcap,
                    double_buffer=db)
                d, c = _counts()
                assert d["prefill_ring_spmd"] == 1, d
                assert d["ring_ppermute"] == data - 1, d
                assert d["prefill_ring_chunk"] == data, d
                assert c["ring_ppermute"] == (data - 1) * 2 * (
                    k.numel() // data) * 4, c
                out[(data, model, window, softcap, db)] = o.numpy()
    return out


def case_decode(rank, world, payload):
    """`paged_decode_spmd` (replicated merge) and `paged_decode_attn_sharded`
    (batch-sharded boundary) with this rank's paged shard, overlap {T, F}."""
    import torch.distributed as dist

    from repro_torch.core import esp
    from repro_torch.kernels import ops

    mesh = _mesh(world, 1)
    kp, vp, tbl, lens, pos = _tensors(*payload["shards"][world][rank])
    q, k_new, v_new = _tensors(payload["dq"], payload["dk"], payload["dv"])
    cl = _tensors(payload["dlens"])[0]
    b = q.shape[0]
    b_l = b // world
    rows = slice(rank * b_l, (rank + 1) * b_l)
    group = mesh.get_group("data")
    out = {}
    for window, softcap in payload["dvariants"]:
        pw = pos if window is not None else None
        for overlap in (True, False):
            ops.reset_dispatch_counts()
            o = esp.paged_decode_spmd(
                mesh, q, k_new, v_new, cl, kp, vp, tbl, lens, pw,
                window=window, softcap=softcap, overlap=overlap)
            d, _ = _counts()
            assert d["pmax"] == 1 and d["psum"] == 1, d
            assert d["paged_decode_partial"] == 1, d
            out[("spmd", window, softcap, overlap)] = o.numpy()
            ops.reset_dispatch_counts()
            o = esp.paged_decode_attn_sharded(
                group, dist.get_world_size(group), q[rows], k_new[rows],
                v_new[rows], cl, kp, vp, tbl, lens, pw, window=window,
                softcap=softcap, overlap=overlap)
            d, _ = _counts()
            assert d["psum_scatter"] == 1 and d["all_gather"] == 1, d
            out[("sharded", window, softcap, overlap)] = o.numpy()
    return out


def _run_e2e(payload, dop, model_ax, seed, check=True, **mesh_kw):
    """One engine: a directly-built prefill batch over every instance, then
    decode to the end.  Returns (tokens per request, dispatch counts after
    the prefill, counts of the whole run, comm bytes)."""
    from repro_torch.engine.executor import MeshExecutor
    from repro_torch.kernels import ops

    mesh = _mesh(dop, model_ax)
    eng = _engine(payload, dop, mesh)
    assert type(eng.executor).__name__ == "MeshExecutor"
    if mesh_kw:
        eng.executor = MeshExecutor(eng, mesh, **mesh_kw)
    here = [p for p in eng.pool.pools if p.mirror_here]
    assert len(here) == 1, [p.mirror_here for p in eng.pool.pools]
    rng = np.random.default_rng(seed)
    batch = prefill_batch(eng, rng, payload["lengths"])
    reqs = list(batch.requests)
    for pool in here:
        pool.device_kv()
        pool.mirror_uploaded_slots = 0
        pool.mirror_full_syncs = 0
    ops.reset_dispatch_counts()
    eng._on_prefill_done(batch)
    d_prefill = dict(ops.dispatch_counts)
    if check:
        for pool in eng.pool.pools:
            assert pool.mirror_uploaded_slots == 0
            assert pool.mirror_full_syncs == 0
            assert pool.host_syncs == 0
        for pool in here:
            assert pool.dirty_slot_count() == 0
    ops.reset_dispatch_counts()
    eng._push(eng.clock, "join", 0)
    m = eng.run()
    assert len(m.finished) == len(reqs)
    d, c = _counts()
    return [list(r.output_tokens) for r in reqs], d_prefill, d, c


def case_engine(rank, world, payload):
    """Engine end to end through the MeshExecutor at DoP = world."""
    toks, d_pre, d, c = _run_e2e(payload, world, 1, payload["seed"][world])
    return {"tokens": toks, "prefill_counts": d_pre, "counts": d,
            "bytes": c}


def case_engine_model2(rank, world, payload):
    """DoP 2 on a (2, 2) mesh: attention replicated over "model"."""
    toks, d_pre, d, c = _run_e2e(payload, 2, 2, payload["seed"][2])
    return {"tokens": toks, "prefill_counts": d_pre, "counts": d}


def case_arms(rank, world, payload):
    """The decode arms: replicated stack, barriered merge, per-shard loop."""
    out = {}
    for arm, kw in (("replicated", {"batch_shard": False}),
                    ("barrier", {"decode_overlap": False}),
                    ("loop", {"spmd_decode": False}),
                    ("sequential_ring", {"double_buffer": False})):
        toks, _, d, c = _run_e2e(payload, world, 1, payload["seed"][world],
                                 **kw)
        out[arm] = {"tokens": toks, "counts": d, "bytes": c}
    return out


def case_join(rank, world, payload):
    """fail_instance mid-decode + join_instance: the failed instance's
    requests recompute or salvage, the rejoined instance takes new work on
    its own mirror, the invariant sanitizer holds after every event."""
    from repro_torch.engine.invariants import InvariantChecker
    from repro_torch.engine.request import Request

    eng = _engine(payload, world, _mesh(world, 1))
    chk = InvariantChecker(eng)
    chk.arm()
    rng = np.random.default_rng(37)
    batch = prefill_batch(eng, rng, [33, 17, 26], rid0=100)
    wave1 = list(batch.requests)
    eng._on_prefill_done(batch)
    t_join = eng.clock + 0.5
    eng.fail_instance(1, at=eng.clock)
    eng.join_instance(1, at=t_join)
    wave2 = []
    for _ in range(3):
        n = int(rng.integers(16, 40))
        r = Request(input_len=n, max_new_tokens=NEW_TOKENS,
                    arrival=t_join + 0.1,
                    prompt=rng.integers(0, eng.cfg.vocab_size, n).tolist())
        wave2.append(r)
        eng.submit(r)
    used = [False]

    def watch(e, kind, payload_):
        if e.clock > t_join and e.pool.pools[1].used > 0:
            used[0] = True

    eng.event_hooks.append(watch)
    prompts = {r.rid: list(r.prompt) for r in wave1 + wave2}
    m = eng.run()
    assert len(m.finished) == len(wave1) + len(wave2)
    assert not eng.failed
    assert used[0], "rejoined instance never took work"
    assert chk.leaked_slots() == 0
    assert eng.pool.total_used == 0
    return {"prompts": [prompts[r.rid] for r in wave1 + wave2],
            "tokens": [list(r.output_tokens) for r in wave1 + wave2]}


def case_checkpoint(rank, world, payload):
    """Checkpoint / restore under the per-rank mirrors: the snapshot syncs
    the stale (fill_packed) host slots exactly once per pool, collectively;
    every rank writes its own file of the same state; the restored engine
    finishes decode."""
    eng = _engine(payload, world, _mesh(world, 1))
    rng = np.random.default_rng(29)
    batch = prefill_batch(eng, rng, [21, 42, 13])
    reqs = list(batch.requests)
    eng._on_prefill_done(batch)
    for pool in eng.pool.pools:
        assert pool.stale_host_slot_count() > 0 and pool.host_syncs == 0
    d = tempfile.mkdtemp(prefix="ckpt_")
    path = os.path.join(d, f"rank{rank}.ckpt")
    eng.checkpoint(path)
    for pool in eng.pool.pools:
        assert pool.host_syncs == 1, pool.host_syncs
        assert pool.stale_host_slot_count() == 0
    eng.checkpoint(path)  # nothing stale: no second sync
    for pool in eng.pool.pools:
        assert pool.host_syncs == 1, pool.host_syncs
    with open(path, "rb") as f:
        blob = f.read()
    eng2 = _engine(payload, world, _mesh(world, 1))
    eng2.restore(path)
    for pool in eng2.pool.pools:
        assert pool._mirror is None
        assert pool.stale_host_slot_count() == 0
    restored = {r.rid: r for g in eng2.ready_decode for r in g.requests}
    assert set(restored) == {r.rid for r in reqs}
    eng2._push(eng2.clock, "join", 0)
    m = eng2.run()
    assert len(m.finished) == len(reqs)
    os.remove(path)
    os.rmdir(d)
    return {"prompts": [list(r.prompt) for r in reqs],
            "tokens": [list(restored[r.rid].output_tokens) for r in reqs],
            "ckpt_bytes": len(blob)}


def case_unified(rank, world, payload):
    """The unified step on the mesh: four short prompts decode while a long
    prompt's chunked prefill runs (``prefill_chunk_tokens=48``); the fused
    iterations run as SPMD steps once two instances hold prefix KV."""
    import copy

    from repro_torch.engine.request import Request
    from repro_torch.kernels import ops
    from repro_torch.manager.scheduler import ManagerConfig

    rng = np.random.default_rng(7)
    reqs = [Request(input_len=24, max_new_tokens=12, arrival=0.0,
                    prompt=rng.integers(0, 256, 24).tolist())
            for _ in range(4)]
    # 600 tokens exceed one 416-slot pool: the long prompt's placement
    # spans both instances, so its later chunks read prefix KV from both
    reqs.append(Request(input_len=600, max_new_tokens=6, arrival=0.01,
                        prompt=rng.integers(0, 256, 600).tolist()))
    ops.reset_dispatch_counts()
    eng = _engine(payload, world, _mesh(world, 1), capacity=416,
                  mcfg=ManagerConfig(prefill_chunk_tokens=48))
    rs = copy.deepcopy(reqs)
    for r in rs:
        eng.submit(r)
    m = eng.run()
    assert len(m.finished) == len(rs)
    d, c = _counts()
    return {"prompts": [list(r.prompt) for r in rs],
            "new": [r.max_new_tokens for r in rs],
            "tokens": [list(r.output_tokens) for r in rs],
            "counts": d, "bytes": c}


def case_guards(rank, world, payload):
    """With data > 1 an instance count other than data raises; with no
    ``mesh=`` the executor builds its mesh over the open world."""
    from repro_torch.engine.server import LoongServeEngine

    out = {}
    try:
        _engine(payload, world + 1, _mesh(world, 1))
        out["instances"] = False
    except ValueError:
        out["instances"] = True
    cfg, model, params = _model(payload)
    eng = LoongServeEngine(cfg, world, 256, store_values=True, model=model,
                           params=params, page_size=16, executor="mesh",
                           device="cpu")
    out["default_mesh"] = (type(eng.executor).__name__ == "MeshExecutor"
                           and eng.executor.data == world)
    return out


CASES = {
    "ring": case_ring,
    "decode": case_decode,
    "engine": case_engine,
    "engine_model2": case_engine_model2,
    "arms": case_arms,
    "join": case_join,
    "checkpoint": case_checkpoint,
    "unified": case_unified,
    "guards": case_guards,
}
