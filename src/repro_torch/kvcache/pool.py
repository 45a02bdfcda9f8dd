"""Token-granularity KV pool backed by page-aligned storage.

LoongServe manages KV "at the granularity of a single token across instances
without any locality constraints" (§1, §4).  Logically nothing changed: a
request's tokens may land on any subset of instances.  Physically, each
instance now backs its slots with fixed-size *pages* so the decode kernel can
attend in place over the pool storage through a per-request block table —
no dense per-request gather on the hot path.

Layout invariant: a request's local tokens are packed densely, in append
order, into pages it owns exclusively.  Local index ``j`` lives in page
``pages[j // P]`` at offset ``j % P`` (slot id ``pages[j // P] * P + j % P``).
``page_size=1`` (the default) degenerates to exact token-granular accounting —
every token is its own page, so there is zero internal fragmentation and the
legacy OutOfSlots semantics hold bit-for-bit.  Larger pages trade a bounded
tail-page slack for kernel-friendly contiguity; ``free_slots`` then reports
whole free pages only (conservative), while a request can always extend into
its own tail slack.

All bookkeeping is vectorized numpy (free page stack, per-request page/pos
arrays) — no per-token dicts anywhere on the hot path.  `bytes_per_slot`
reflects the real bf16 KV footprint so pool capacities model HBM honestly.

KV lifecycle (host bookkeeping vs device-resident storage)
----------------------------------------------------------
The pool holds TWO coupled copies of the stored KV:

  * the host numpy arrays ``k``/``v``/``slot_pos`` — the management plane.
    Placement planning, migration, gather, SWA eviction and checkpoints all
    read/write these; they are cheap to mutate token-granularly.
  * a device mirror (``device_kv()``) — the compute plane the paged decode
    kernel attends *in place* through block tables.

Writes through ``write``/``fill`` land on the host copy and mark the touched
slots dirty; the next ``device_kv()`` call uploads only those slots (or does
one full resync after load/failure).  ``fill_packed`` is the write-through
fast path for packed prefill: the KV is already device-resident (produced by
the packed prefill step), so it is scattered straight into the mirror
device-to-device and the slots are marked STALE on the host instead of being
downloaded — the prefill critical path stays device-only.  The host
management copy lazily resyncs FROM the mirror only when a management
operation actually reads it (``gather`` for migration/debug, SWA compaction,
checkpointing); ``host_syncs`` counts those forced downloads and the
``mirror_full_syncs``/``mirror_uploaded_slots`` counters let tests and
benchmarks assert the zero-re-upload invariant.

Ring-step KV ownership (DoP>1 ESP prefill) — see DESIGN.md §6
-------------------------------------------------------------
Under the fused striped ring, the packed token axis of a prefill batch is
striped across the group's instances (global packed column ``g`` belongs to
instance ``g % n``); each ring step circulates the KV *chunks* between
instances, but ownership never moves: every instance write-throughs exactly
the packed columns of its own reserved placement (``batch.placement``) via
``fill_packed``, the same columns its stripe produced.  Proactive ESP
scale-down therefore stays zero-copy — the scheduler reserves the shrunken
group's slots BEFORE the ring runs, the ring pass deposits each column at
its final home as a side effect of computation, and no post-hoc migration of
the dropped instances' shards is ever needed (their columns were simply
never assigned to them).

The executor pins every mirror to the engine's device (``bind_device``).
Checkpoints snapshot occupied-slot KV values from the host copy (forcing
the deferred stale-slot download exactly once); restore drops the mirror
and rebuilds it from host on the bound device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class OutOfSlots(RuntimeError):
    pass


def _mirror_scatter(mirror, idx, kn, vn, pn) -> None:
    """(K, V, slot_pos) mirror scatter, shared by the dirty sync and the
    packed-prefill write-through.  The reference jits a donated functional
    scatter; PyTorch updates the mirror IN PLACE with `index_copy_` along the
    slot axis — O(idx), no copy of the mirror, nothing to compile."""
    kd, vd, pd = mirror
    kd.index_copy_(1, idx, kn)
    vd.index_copy_(1, idx, vn)
    pd.index_copy_(0, idx, pn)


def _pad_bucket(n: int) -> int:
    """Power-of-two bucket (the executor's padding buckets share it)."""
    return 1 << max(n - 1, 0).bit_length()


@dataclass
class TokenRef:
    """Where one token's KV lives."""

    instance: int
    slot: int


class _ReqState:
    """Per-request paged bookkeeping: owned pages + global positions, both
    as amortized-growth numpy arrays indexed by local token order."""

    __slots__ = ("pages", "n_pages", "pos", "n_tok", "max_pos")

    def __init__(self):
        self.pages = np.empty(4, np.int32)
        self.n_pages = 0
        self.pos = np.empty(8, np.int64)
        self.n_tok = 0
        self.max_pos = -1  # O(1) is-new check for the append hot path

    def _grow(self, arr: np.ndarray, need: int) -> np.ndarray:
        if need <= len(arr):
            return arr
        new = np.empty(max(need, 2 * len(arr)), arr.dtype)
        new[: len(arr)] = arr
        return new

    def append_pages(self, new_pages: np.ndarray) -> None:
        self.pages = self._grow(self.pages, self.n_pages + len(new_pages))
        self.pages[self.n_pages : self.n_pages + len(new_pages)] = new_pages
        self.n_pages += len(new_pages)

    def append_pos(self, positions: np.ndarray) -> None:
        self.pos = self._grow(self.pos, self.n_tok + len(positions))
        self.pos[self.n_tok : self.n_tok + len(positions)] = positions
        self.n_tok += len(positions)
        if len(positions):
            self.max_pos = max(self.max_pos, int(positions.max()))


class KVPool:
    """Per-instance pool: token-granular slots on page-aligned storage."""

    def __init__(self, cfg: ModelConfig, capacity: int, instance_id: int = 0,
                 store_values: bool = True, page_size: int = 1):
        assert page_size >= 1 and capacity % page_size == 0, (
            capacity, page_size
        )
        self.cfg = cfg
        self.capacity = int(capacity)
        self.instance_id = instance_id
        self.store_values = store_values
        self.page_size = int(page_size)
        self.n_pages = self.capacity // self.page_size
        n_attn = max(cfg.n_attention_applications, 1)
        self.n_attn = n_attn
        # free page stack: pop from the end
        self._free_pages = np.arange(self.n_pages - 1, -1, -1, dtype=np.int32)
        self._n_free_pages = self.n_pages
        self._reqs: Dict[int, _ReqState] = {}
        self._used_tokens = 0
        # global position of the token stored in each slot (-1 = unoccupied)
        self.slot_pos = np.full(self.capacity, -1, np.int32)
        if store_values:
            shape = (n_attn, self.capacity, cfg.n_kv_heads, cfg.head_dim)
            self.k = np.zeros(shape, np.float32)
            self.v = np.zeros(shape, np.float32)
        # device-mirror dirty tracking + the mirror itself (compute plane)
        self._dirty_full = True
        self._dirty: List[np.ndarray] = []
        self._dirty_count = 0
        self._mirror = None  # (k_dev, v_dev, slot_pos_dev) torch tensors
        self.device = None  # mirror placement: set by bind_device()
        self.mirror_full_syncs = 0
        self.mirror_uploaded_slots = 0
        # lazy host copy: slots whose authoritative KV lives only in the
        # mirror (landed via `fill_packed`); synced down on demand by the
        # management plane (gather / SWA compaction / checkpoint)
        self._stale_host = np.zeros(self.capacity, bool)
        self._stale_count = 0
        self.host_syncs = 0

    # ------------------------------------------------------------- accounting
    @property
    def used(self) -> int:
        """Allocated *tokens* (not pages)."""
        return self._used_tokens

    @property
    def free_slots(self) -> int:
        """Tokens guaranteed allocatable by ANY request: whole free pages.
        (A request holding a partially-filled tail page can additionally
        extend into its own slack.)  Exact for page_size=1."""
        return self._n_free_pages * self.page_size

    @property
    def bytes_per_slot(self) -> int:
        return max(self.cfg.kv_bytes_per_token, 1)

    def requests(self) -> List[int]:
        return list(self._reqs)

    def slots_of(self, request_id: int) -> np.ndarray:
        """Slot ids in local (append) order — vectorized."""
        st = self._reqs.get(request_id)
        if st is None:
            return np.empty(0, np.int64)
        return self.slots_of_state(st)

    def tokens_of(self, request_id: int) -> Dict[int, int]:
        """Legacy mapping {global_pos: slot} (planning / tests)."""
        st = self._reqs.get(request_id)
        if st is None:
            return {}
        return dict(zip(st.pos[: st.n_tok].tolist(),
                        self.slots_of(request_id).tolist()))

    # ------------------------------------------------------------- alloc/free
    def _pop_pages(self, n: int) -> np.ndarray:
        pages = self._free_pages[self._n_free_pages - n : self._n_free_pages]
        self._n_free_pages -= n
        return pages.copy()

    def _push_pages(self, pages: np.ndarray) -> None:
        n = len(pages)
        self._free_pages[self._n_free_pages : self._n_free_pages + n] = pages
        self._n_free_pages += n

    def alloc(self, request_id: int, positions: Sequence[int]) -> List[int]:
        pos = np.asarray(positions, np.int64)
        n = len(pos)
        st = self._reqs.get(request_id)
        slack = (st.n_pages * self.page_size - st.n_tok) if st else 0
        need_pages = max(0, -(-(n - slack) // self.page_size)) if n > slack else 0
        if need_pages > self._n_free_pages:
            raise OutOfSlots(
                f"instance {self.instance_id}: need {n} tokens "
                f"({need_pages} pages), free {self.free_slots} tokens "
                f"({self._n_free_pages} pages)"
            )
        if st is None:
            st = self._reqs[request_id] = _ReqState()
        # duplicate guard: the decode hot path (single append past max_pos)
        # is O(1); the full scans only run for bulk/out-of-order allocs
        if n > 1:
            assert len(np.unique(pos)) == n, (request_id, positions)
        if n and st.n_tok and not (n == 1 and int(pos[0]) > st.max_pos):
            assert not np.isin(pos, st.pos[: st.n_tok]).any(), (
                request_id, positions
            )
        if need_pages:
            st.append_pages(self._pop_pages(need_pages))
        start = st.n_tok
        st.append_pos(pos)
        self._used_tokens += n
        slots = self._local_slots(st, start, n)
        self.slot_pos[slots] = pos
        return slots.tolist()

    def _local_slots(self, st: _ReqState, start: int, n: int) -> np.ndarray:
        """Slot ids for local indices [start, start+n)."""
        if n == 0:
            return np.empty(0, np.int64)
        j = np.arange(start, start + n)
        return st.pages[j // self.page_size].astype(np.int64) * self.page_size \
            + j % self.page_size

    def free_request(self, request_id: int) -> int:
        st = self._reqs.pop(request_id, None)
        if st is None:
            return 0
        self.slot_pos[self.slots_of_state(st)] = -1
        self._push_pages(st.pages[: st.n_pages])
        self._used_tokens -= st.n_tok
        return st.n_tok

    def slots_of_state(self, st: _ReqState) -> np.ndarray:
        return self._local_slots(st, 0, st.n_tok)

    def free_positions(self, request_id: int, positions: Sequence[int]) -> int:
        """Free specific token positions (SWA window eviction).  The request's
        surviving tokens are compacted so the packed-page layout invariant is
        preserved; emptied tail pages return to the free stack."""
        st = self._reqs.get(request_id)
        if st is None:
            return 0
        drop = np.isin(st.pos[: st.n_tok], np.asarray(positions, np.int64))
        n_drop = int(drop.sum())
        if n_drop == 0:
            return 0
        self._sync_host()  # compaction moves host KV between slots
        old_slots = self.slots_of_state(st)
        keep_slots = old_slots[~drop]
        keep_pos = st.pos[: st.n_tok][~drop]
        n_keep = st.n_tok - n_drop
        if n_keep == 0:
            self.free_request(request_id)
            return n_drop
        self.slot_pos[old_slots] = -1
        st.n_tok = 0  # rebuild the packed prefix
        st.pos[:n_keep] = keep_pos
        st.n_tok = n_keep
        st.max_pos = int(keep_pos.max())
        new_slots = self._local_slots(st, 0, n_keep)
        moved = new_slots != keep_slots
        if self.store_values and moved.any():
            # fancy-index gather materializes the RHS first, so overlapping
            # src/dst ranges are safe
            self.k[:, new_slots[moved]] = self.k[:, keep_slots[moved]]
            self.v[:, new_slots[moved]] = self.v[:, keep_slots[moved]]
            self._mark_dirty(new_slots[moved])
        self.slot_pos[new_slots] = keep_pos
        n_pages_keep = -(-n_keep // self.page_size)
        if n_pages_keep < st.n_pages:
            self._push_pages(st.pages[n_pages_keep: st.n_pages])
            st.n_pages = n_pages_keep
        self._used_tokens -= n_drop
        return n_drop

    def positions_of(self, request_id: int) -> np.ndarray:
        """Sorted global positions this pool holds for `request_id` (the
        instance's leg of a sparse coverage map; empty when absent)."""
        st = self._reqs.get(request_id)
        if st is None:
            return np.empty(0, np.int64)
        return np.sort(st.pos[: st.n_tok].copy())

    def insert_positions(self, request_id: int, positions: Sequence[int]) -> List[int]:
        """Reserve positions that may PRECEDE positions the request already
        holds here (fault salvage re-reserves a dead rank's stripe on the
        survivors, whose own stripes sit at higher positions).  `alloc`
        appends, which would break the position-ascending local order
        `prefix_block_table` relies on; this restores it by permuting the
        request's local indices — and the stored KV with them — after the
        append.  The inserted slots hold no KV yet: the recovery chain
        fills them through the usual `slots_for` + fill paths."""
        pos = np.sort(np.asarray(positions, np.int64))
        if len(pos) == 0:
            return []
        st = self._reqs.get(request_id)
        if st is None or st.n_tok == 0 or int(pos[0]) > st.max_pos:
            return self.alloc(request_id, pos)  # plain append stays sorted
        if self.store_values:
            self._sync_host()  # the permutation moves host KV between slots
        self.alloc(request_id, pos)
        st = self._reqs[request_id]
        cur = st.pos[: st.n_tok].copy()
        order = np.argsort(cur, kind="stable")
        slots = self.slots_of_state(st)
        moved = order != np.arange(st.n_tok)
        if self.store_values and moved.any():
            # fancy-index gather materializes the RHS first, so overlapping
            # src/dst slot sets are safe; local index j takes the KV that
            # lived at local index order[j]
            self.k[:, slots[moved]] = self.k[:, slots[order[moved]]]
            self.v[:, slots[moved]] = self.v[:, slots[order[moved]]]
            self._mark_dirty(slots[moved])
        st.pos[: st.n_tok] = cur[order]
        self.slot_pos[slots] = cur[order]
        return slots[np.searchsorted(cur[order], pos)].tolist()

    # ------------------------------------------------------------------ data
    def _mark_dirty(self, slots: np.ndarray) -> None:
        if self._dirty_full or len(slots) == 0:
            return
        self._dirty.append(np.asarray(slots, np.int64))
        self._dirty_count += len(slots)
        if self._dirty_count > self.capacity // 4:
            self._dirty_full = True
            self._dirty.clear()
            self._dirty_count = 0

    def _mark_stale_host(self, slots: np.ndarray) -> None:
        if len(slots):  # count updates are O(len(slots)), not O(capacity)
            self._stale_count += len(slots) - int(
                np.count_nonzero(self._stale_host[slots])
            )
            self._stale_host[slots] = True

    def _clear_stale_host(self, slots: np.ndarray) -> None:
        """Host-side writes (`write`/`fill`) make the host authoritative for
        their slots again (reused pages may carry a stale flag from a freed
        request) — drop the flag WITHOUT downloading."""
        if self._stale_count and len(slots):
            self._stale_count -= int(np.count_nonzero(self._stale_host[slots]))
            self._stale_host[slots] = False

    def stale_host_slot_count(self) -> int:
        """Slots whose host copy is behind the device mirror (the probe for
        the lazy-host-copy invariant: >0 right after a packed prefill, 0
        after any management-plane read forced a sync)."""
        return self._stale_count

    def _sync_host(self) -> None:
        """On-demand download of stale slots from the mirror to the host
        management copy (migration / gather / SWA compaction / checkpoints
        read it).  Off the prefill critical path by construction."""
        if self._stale_count == 0:
            return
        slots = np.nonzero(self._stale_host)[0]
        if self._mirror is not None:
            kd, vd, _ = self._mirror
            # `.cpu()` first: numpy cannot read a CUDA tensor
            idx = self._dev_put(slots)
            self.k[:, slots] = kd.index_select(1, idx).float().cpu().numpy()
            self.v[:, slots] = vd.index_select(1, idx).float().cpu().numpy()
            self.host_syncs += 1
        self._stale_host[:] = False
        self._stale_count = 0

    def dirty_slot_count(self) -> int:
        """Slots the next `device_kv()` sync would upload (capacity if a
        full resync is pending) — the public probe for the write-through
        invariant: 0 right after a packed prefill."""
        return self.capacity if self._dirty_full else self._dirty_count

    def consume_dirty(self) -> Tuple[bool, np.ndarray]:
        """(full_resync_needed, dirty slot ids) since the last call; resets.
        The engine's device mirror applies these incrementally instead of
        re-uploading the pool every iteration."""
        full, dirty = self._dirty_full, self._dirty
        self._dirty_full = False
        self._dirty = []
        self._dirty_count = 0
        if full:
            return True, np.empty(0, np.int64)
        if not dirty:
            return False, np.empty(0, np.int64)
        return False, np.unique(np.concatenate(dirty))

    def write(self, request_id: int, positions: Sequence[int],
              k: np.ndarray, v: np.ndarray) -> None:
        """k/v: [n_attn, n_tokens, KVH, D] for `positions` (allocates)."""
        slots = np.asarray(self.alloc(request_id, positions), np.int64)
        if self.store_values:
            self._clear_stale_host(slots)
            self.k[:, slots] = np.asarray(k, np.float32)
            self.v[:, slots] = np.asarray(v, np.float32)
            self._mark_dirty(slots)

    def slots_for(self, request_id: int, positions: Sequence[int]) -> np.ndarray:
        """Slot ids of ALREADY-ALLOCATED global positions (any order)."""
        st = self._reqs[request_id]
        pos = np.asarray(positions, np.int64)
        if len(pos) == 0:
            return np.empty(0, np.int64)
        cur = st.pos[: st.n_tok]
        sorter = np.argsort(cur, kind="stable")
        # clip so an unknown position reaches the diagnostic assert below
        # instead of an opaque IndexError
        ss = np.minimum(np.searchsorted(cur, pos, sorter=sorter), st.n_tok - 1)
        li = sorter[ss]
        assert (cur[li] == pos).all(), (request_id, positions)
        return self.slots_of_state(st)[li]

    def fill(self, request_id: int, positions: Sequence[int],
             k: np.ndarray, v: np.ndarray) -> None:
        """Write values into ALREADY-RESERVED slots (proactive scale-down:
        the scheduler reserves placement, the prefill ring fills it)."""
        if not self.store_values:
            return
        slots = self.slots_for(request_id, positions)
        if len(slots) == 0:
            return
        self._clear_stale_host(slots)
        self.k[:, slots] = np.asarray(k, np.float32)
        self.v[:, slots] = np.asarray(v, np.float32)
        self._mark_dirty(slots)

    # --------------------------------------------------------- device mirror
    def bind_device(self, device) -> None:
        """Pin this instance's compute-plane mirror to `device` (a
        `torch.device`): `fill_packed` write-through lands the prefill's
        reserved placement columns there, and the paged decode partial over
        this pool runs there.  The executor binds every pool to the engine's
        device.  Rebinding drops the mirror (next `device_kv()` rebuilds it
        in place)."""
        device = torch.device(device)
        if device != self.device:
            if self._mirror is not None:
                self._sync_host()  # keep fill_packed KV across the rebind
            self.device = device
            self.drop_mirror()

    def _dev_put(self, x) -> torch.Tensor:
        """Copy a numpy array (or tensor) to the bound device.  Always a copy:
        on the CPU `torch.from_numpy` would alias the host management copy."""
        if self.device is None:
            raise RuntimeError(
                f"KVPool {self.instance_id}: no device bound for the mirror "
                "(call bind_device first)"
            )
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, copy=True)

    def device_kv(self):
        """Incrementally-synced device mirror of the (K, V, slot_pos)
        storage.  Steady-state decode uploads only the slots written since
        the last call (one per request per iteration), not the pool; slots
        landed through `fill_packed` were written device-side already and
        upload nothing."""
        assert self.store_values, "device mirror needs value storage"
        full, dirty = self.consume_dirty()
        cur = self._mirror
        if cur is None or full:
            # a full resync uploads the HOST copy wholesale: pull any
            # stale-host slots (authoritative only in the mirror) down first
            # or their KV would be overwritten with never-synced host data
            self._sync_host()
            cur = (self._dev_put(self.k), self._dev_put(self.v),
                   self._dev_put(self.slot_pos))
            self.mirror_full_syncs += 1
            self.mirror_uploaded_slots += self.capacity
        elif len(dirty):
            _mirror_scatter(
                cur, self._dev_put(dirty), self._dev_put(self.k[:, dirty]),
                self._dev_put(self.v[:, dirty]),
                self._dev_put(self.slot_pos[dirty]),
            )
            self.mirror_uploaded_slots += len(dirty)
        self._mirror = cur
        return cur

    def device_paged_kv(self):
        """Page-shaped view of the device mirror — the per-instance launch
        operand of the paged decode loop: ``(k, v, pos)`` viewed as
        ``[n_attn, n_pages, P, KVH, D]`` / ``[n_pages, P]`` on the bound
        device.  Runs the same incremental dirty sync as `device_kv()`; the
        view shares the mirror's storage, so no KV byte moves."""
        kd, vd, pd = self.device_kv()
        paged = (self.n_attn, self.n_pages, self.page_size) + tuple(kd.shape[2:])
        return (
            kd.view(paged), vd.view(paged),
            pd.view(self.n_pages, self.page_size),
        )

    def drop_mirror(self) -> None:
        """Invalidate the device mirror (instance failure / state restore);
        the next `device_kv()` rebuilds it with one full upload.  Pending
        stale-host slots are dropped with it: both callers (failure, restore)
        discard the stored KV values anyway."""
        self._mirror = None
        self._dirty_full = True
        self._dirty = []
        self._dirty_count = 0
        self._stale_host[:] = False
        self._stale_count = 0

    def fill_packed(self, slots: np.ndarray, k_dev, v_dev) -> None:
        """Device-side write-through fill: scatter DEVICE-RESIDENT KV (e.g.
        the packed prefill step's per-layer output) straight into the mirror
        at `slots` (block-table rows) WITHOUT dirtying — the next
        `device_kv()` sync uploads nothing for these slots — and WITHOUT
        downloading to the host: the slots are marked stale and the host
        management copy pulls them from the mirror on demand (`_sync_host`),
        keeping the prefill critical path device-only.
        `k_dev`/`v_dev`: [n_attn, len(slots), KVH, D] tensors."""
        if not self.store_values:
            return
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        kd, vd, pd = self.device_kv()  # sync any stale dirty slots first
        # the packed step's output is cast to the mirror's type (f32) on the
        # mirror's device before the in-place scatter
        kn = k_dev.to(device=kd.device, dtype=kd.dtype)
        vn = v_dev.to(device=vd.device, dtype=vd.dtype)
        _mirror_scatter(
            self._mirror, self._dev_put(slots), kn, vn,
            self._dev_put(self.slot_pos[slots]),
        )
        # lazy host copy: defer the device->host download to the first
        # management-plane read (migration / gather / SWA / checkpoint)
        self._mark_stale_host(slots)

    def gather(self, request_id: int) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        """Returns (positions sorted, k, v) for this instance's share.
        Off the hot path now (migration / debugging / legacy baselines);
        decode reads the pool in place via `block_table`."""
        st = self._reqs.get(request_id)
        if st is None:
            pos = np.empty(0, np.int64)
        else:
            pos = st.pos[: st.n_tok]
        order = np.argsort(pos, kind="stable")
        positions = pos[order]
        if not self.store_values:
            return positions, None, None
        self._sync_host()
        if len(positions) == 0:
            empty = np.zeros((self.n_attn, 0) + self.k.shape[2:], np.float32)
            return positions, empty, empty.copy()
        slots = self.slots_of_state(st)[order]
        return positions, self.k[:, slots], self.v[:, slots]

    # ------------------------------------------------------------ paged views
    def block_table(self, request_ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Per-request page tables over THIS pool's storage.

        Returns (table [B, max_pages] int32 — padded with page 0 — and
        lengths [B] int32 — the number of local valid tokens per request).
        Requests with no tokens here get length 0.  Feeding this straight to
        the paged decode kernel is the gather-free hot path.
        """
        states = [self._reqs.get(rid) for rid in request_ids]
        lengths = np.array([st.n_tok if st else 0 for st in states], np.int32)
        max_pages = max((st.n_pages for st in states if st), default=0)
        table = np.zeros((len(states), max_pages), np.int32)
        for b, st in enumerate(states):
            if st:
                table[b, : st.n_pages] = st.pages[: st.n_pages]
        return table, lengths

    def prefix_block_table(
        self, request_ids: Sequence[int], limits: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`block_table` restricted to each request's FILLED prefix.

        ``block_table`` counts every allocated slot — including slots a
        mid-prefill request reserved up front but has not written yet.  The
        unified chunked step must attend only positions ``< limits[b]`` (the
        request's prefill cursor; ``seq_len - 1`` for decode rows), so this
        returns the same table with lengths clipped to the filled prefix.
        Valid because `alloc` appends slots in ascending position order (the
        striped placement plans are per-instance ascending), so the filled
        prefix occupies exactly the first ``eff`` slots of the table order —
        asserted below.
        """
        states = [self._reqs.get(rid) for rid in request_ids]
        lengths = np.zeros(len(states), np.int32)
        for b, st in enumerate(states):
            if st is None:
                continue
            pos = st.pos[: st.n_tok]
            lim = int(limits[b])
            eff = int((pos < lim).sum())
            assert (pos[:eff] < lim).all() and (pos[eff:] >= lim).all(), (
                "prefix_block_table: allocation order is not position-sorted",
                request_ids[b], lim, pos,
            )
            lengths[b] = eff
        max_pages = max((st.n_pages for st in states if st), default=0)
        table = np.zeros((len(states), max_pages), np.int32)
        for b, st in enumerate(states):
            if st:
                table[b, : st.n_pages] = st.pages[: st.n_pages]
        return table, lengths

    @property
    def k_pages(self) -> np.ndarray:
        """[n_attn, n_pages, page_size, KVH, D] view of the K storage."""
        self._sync_host()
        return self.k.reshape(self.n_attn, self.n_pages, self.page_size,
                              *self.k.shape[2:])

    @property
    def v_pages(self) -> np.ndarray:
        self._sync_host()
        return self.v.reshape(self.n_attn, self.n_pages, self.page_size,
                              *self.v.shape[2:])

    @property
    def pos_pages(self) -> np.ndarray:
        """[n_pages, page_size] global position per slot (-1 = unoccupied)."""
        return self.slot_pos.reshape(self.n_pages, self.page_size)

    # ------------------------------------------------------- checkpointing
    def state_dict(self) -> Dict[str, object]:
        state: Dict[str, object] = {
            "free_pages": self._free_pages.copy(),
            "n_free_pages": self._n_free_pages,
            "used_tokens": self._used_tokens,
            "slot_pos": self.slot_pos.copy(),
            "reqs": {
                rid: (st.pages[: st.n_pages].copy(), st.pos[: st.n_tok].copy())
                for rid, st in self._reqs.items()
            },
        }
        if self.store_values:
            # checkpoints snapshot the host copy: force the deferred
            # device->host download of fill_packed slots (counted in
            # `host_syncs`; at most once — a second snapshot with nothing
            # stale downloads nothing), then persist only OCCUPIED slots so
            # the checkpoint scales with live KV, not pool capacity.
            self._sync_host()
            occ = np.nonzero(self.slot_pos >= 0)[0]
            state["kv_slots"] = occ
            state["k"] = self.k[:, occ].copy()
            state["v"] = self.v[:, occ].copy()
        return state

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self._free_pages = state["free_pages"].copy()
        self._n_free_pages = state["n_free_pages"]
        self._used_tokens = state["used_tokens"]
        self.slot_pos = state["slot_pos"].copy()
        self._reqs = {}
        for rid, (pages, pos) in state["reqs"].items():
            st = _ReqState()
            st.append_pages(np.asarray(pages, np.int32))
            st.append_pos(np.asarray(pos, np.int64))
            self._reqs[rid] = st
        if self.store_values and "kv_slots" in state:
            # real-mode restore reproduces the oracle sequence without a
            # recompute pass: the host copy is authoritative again and the
            # dropped (per-shard) mirror rebuilds from it on first use
            self.k[:] = 0.0
            self.v[:] = 0.0
            occ = state["kv_slots"]
            self.k[:, occ] = state["k"]
            self.v[:, occ] = state["v"]
        self.drop_mirror()

    def evict(self, request_id: int) -> int:
        """Evict a request entirely (recompute later). Returns freed tokens."""
        return self.free_request(request_id)
