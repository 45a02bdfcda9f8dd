"""The port's KV pool: the bookkeeping copied from the reference behaves
identically, and the torch device mirror keeps the reference's contract —
incremental dirty sync with `index_copy_`, `fill_packed` write-through with
zero re-upload, a lazy host copy synced on demand (`host_syncs`), and a
full resync that preserves write-through KV.  The mirror cases follow
tests/test_paged_pool.py, tests/test_kvpool.py and the pool cases of
tests/test_packed_prefill.py / tests/test_ring_prefill.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.kvcache import KVPool as JPool  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.request import Phase, Request  # noqa: E402
from repro_torch.engine.server import LoongServeEngine  # noqa: E402
from repro_torch.kvcache import KVPool  # noqa: E402
from repro_torch.manager.scheduler import PrefillBatch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

JCFG = reduced(REGISTRY["lwm-7b"], n_layers=2)
CFG = t_reduced(T_REGISTRY["lwm-7b"], n_layers=2)
CPU = torch.device("cpu")


def _kv(rng, n):
    shape = (CFG.n_layers, n, CFG.n_kv_heads, CFG.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _pool(capacity=64, page_size=4):
    pool = KVPool(CFG, capacity, 0, True, page_size)
    pool.bind_device(CPU)
    return pool


@pytest.mark.parametrize("page_size", [1, 4])
def test_bookkeeping_matches_reference(page_size):
    """Interleaved alloc / free / SWA eviction: block tables, lengths and
    slot positions equal the reference pool's."""
    tp = KVPool(CFG, 64, 0, False, page_size)
    jp = JPool(JCFG, 64, 0, False, page_size)
    ops = [("alloc", 1, range(0, 9)), ("alloc", 2, range(0, 5)),
           ("alloc", 1, [9, 10]), ("free_pos", 1, [0, 1, 2]),
           ("alloc", 3, range(0, 13)), ("free", 2, None),
           ("alloc", 4, range(0, 6)), ("alloc", 3, [13])]
    for kind, rid, pos in ops:
        for p in (tp, jp):
            if kind == "alloc":
                p.alloc(rid, list(pos))
            elif kind == "free_pos":
                p.free_positions(rid, list(pos))
            else:
                p.free_request(rid)
        tt, tl = tp.block_table([1, 3, 4, 2])
        jt, jl = jp.block_table([1, 3, 4, 2])
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tp.slot_pos, jp.slot_pos)
        assert tp.free_slots == jp.free_slots and tp.used == jp.used


def test_unbound_mirror_raises():
    pool = KVPool(CFG, 16, 0, True, 1)
    with pytest.raises(RuntimeError, match="bind_device"):
        pool.device_kv()


def test_incremental_dirty_sync_uploads_only_written_slots():
    rng = np.random.default_rng(0)
    pool = _pool()
    pool.device_kv()  # creation: one full sync
    assert pool.mirror_full_syncs == 1
    assert pool.mirror_uploaded_slots == pool.capacity
    k, v = _kv(rng, 6)
    pool.write(7, list(range(6)), k, v)
    assert pool.dirty_slot_count() == 6
    kd, vd, pd = pool.device_kv()
    assert pool.mirror_full_syncs == 1
    assert pool.mirror_uploaded_slots == pool.capacity + 6
    assert pool.dirty_slot_count() == 0
    np.testing.assert_array_equal(kd.numpy(), pool.k)
    np.testing.assert_array_equal(vd.numpy(), pool.v)
    np.testing.assert_array_equal(pd.numpy(), pool.slot_pos)
    kp, vp, pp = pool.device_paged_kv()
    assert kp.shape == (CFG.n_layers, pool.n_pages, 4, CFG.n_kv_heads,
                        CFG.head_dim)
    assert pp.shape == (pool.n_pages, 4)
    assert kp.data_ptr() == kd.data_ptr()  # a view: no KV byte moves
    # the mirror is a copy, never an alias of the host management copy
    assert kd.data_ptr() != pool.k.__array_interface__["data"][0]


def test_fill_packed_write_through_and_lazy_host_copy():
    rng = np.random.default_rng(1)
    pool = _pool()
    pool.device_kv()
    pool.mirror_uploaded_slots = pool.mirror_full_syncs = 0
    slots = np.asarray(pool.alloc(3, list(range(10))), np.int64)
    k, v = _kv(rng, 10)
    pool.fill_packed(slots, torch.from_numpy(k), torch.from_numpy(v))
    assert pool.dirty_slot_count() == 0
    assert pool.stale_host_slot_count() == 10
    assert pool.host_syncs == 0
    kd, _, pd = pool.device_kv()  # the next decode's sync uploads nothing
    assert pool.mirror_uploaded_slots == 0 and pool.mirror_full_syncs == 0
    np.testing.assert_array_equal(kd[:, slots].numpy(), k)
    np.testing.assert_array_equal(pd.numpy(), pool.slot_pos)
    pos, kg, vg = pool.gather(3)  # management read: one forced sync
    assert pool.host_syncs == 1 and pool.stale_host_slot_count() == 0
    np.testing.assert_array_equal(kg, k)
    np.testing.assert_array_equal(vg, v)
    pool.gather(3)
    assert pool.host_syncs == 1  # nothing stale: no second download
    state = pool.state_dict()  # checkpoint reads the (synced) host copy
    assert pool.host_syncs == 1
    np.testing.assert_array_equal(state["k"], pool.k[:, state["kv_slots"]])


def test_state_dict_forces_the_deferred_sync():
    rng = np.random.default_rng(2)
    pool = _pool()
    slots = np.asarray(pool.alloc(5, list(range(7))), np.int64)
    k, v = _kv(rng, 7)
    pool.fill_packed(slots, torch.from_numpy(k), torch.from_numpy(v))
    assert pool.stale_host_slot_count() == 7 and pool.host_syncs == 0
    pool.state_dict()
    assert pool.stale_host_slot_count() == 0 and pool.host_syncs == 1
    kd, _, _ = pool.device_kv()
    np.testing.assert_array_equal(kd.numpy(), pool.k)


def test_full_resync_preserves_stale_fill_packed_kv():
    """A host-write burst past capacity/4 forces a full resync, which must
    first pull the write-through slots down instead of overwriting them."""
    rng = np.random.default_rng(3)
    pool = _pool(capacity=64)
    slots = np.asarray(pool.alloc(1, list(range(12))), np.int64)
    k, v = _kv(rng, 12)
    pool.fill_packed(slots, torch.from_numpy(k), torch.from_numpy(v))
    kb, vb = _kv(rng, 20)
    pool.write(2, list(range(100, 120)), kb, vb)
    assert pool.dirty_slot_count() == pool.capacity  # full resync pending
    kd, _, _ = pool.device_kv()
    np.testing.assert_array_equal(kd[:, slots].numpy(), k)
    assert pool.host_syncs == 1


def test_rebind_to_bound_device_keeps_mirror():
    rng = np.random.default_rng(4)
    pool = _pool()
    slots = np.asarray(pool.alloc(1, list(range(5))), np.int64)
    k, v = _kv(rng, 5)
    pool.fill_packed(slots, torch.from_numpy(k), torch.from_numpy(v))
    mirror = pool._mirror
    pool.bind_device("cpu")  # the bound device again: the mirror stays
    assert pool._mirror is mirror and pool.host_syncs == 0
    kd, _, _ = pool.device_kv()
    np.testing.assert_array_equal(kd[:, slots].numpy(), k)


def test_engine_packed_prefill_then_decode_uploads_zero_slots():
    """Engine level: after a packed prefill (DoP=2 ring) no slot is dirty,
    the first decode uploads 0 slots, and nothing was downloaded."""
    jm_tree = jax.tree.map(np.asarray,
                           j_build_model(JCFG).init(jax.random.PRNGKey(0)))
    model = build_model(CFG, device="cpu")
    params = params_from_numpy(CFG, jm_tree, device="cpu")
    eng = LoongServeEngine(CFG, 2, 512, store_values=True, model=model,
                           params=params, page_size=8, device="cpu")
    for pool in eng.pool.pools:
        pool.device_kv()
        pool.mirror_uploaded_slots = pool.mirror_full_syncs = 0
    rng = np.random.default_rng(5)
    reqs, placement = [], {}
    for j, n in enumerate([21, 40, 9]):
        r = Request(input_len=n, max_new_tokens=3,
                    prompt=rng.integers(0, CFG.vocab_size, n).tolist())
        r.rid, r.phase = 1000 + j, Phase.PREFILL
        plan = eng.pool.plan_placement(r.rid, list(range(n)), range(2))
        eng.pool.place(plan)
        placement[r.rid] = plan.assignment
        reqs.append(r)
    batch = PrefillBatch(reqs, [0, 1], scale_down_to=[0, 1],
                         placement=placement)
    eng._on_prefill_done(batch)
    for pool in eng.pool.pools:
        assert pool.dirty_slot_count() == 0
        assert pool.stale_host_slot_count() > 0 and pool.host_syncs == 0
        pool.device_kv()
        assert pool.mirror_uploaded_slots == 0
        assert pool.mirror_full_syncs == 0
