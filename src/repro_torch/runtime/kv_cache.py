"""KV-cache memory management — paper §3.2/§3.3 applied to serving.

The serving engine's HBM picture mirrors the paper's mobile-RAM picture:

* *shape inference*: per-request peak cache bytes are computed statically
  from the model config and requested context length,
* *arena isolation*: each admitted request's caches live in their own
  slab (no cross-request reallocation when a request finishes early),
* *cross-arena reuse*: finished requests' slabs return to a
  :class:`repro_torch.core.arena.SlabPool` and back later requests' arenas.

Two granularities are provided:

* :class:`KVCacheManager` — one monolithic whole-lifetime slab per
  request (the round-based baseline engine), and
* :class:`BlockKVCache` — per-slot *block tables* over a pool of
  fixed-size cache blocks, allocated lazily as sequences grow and
  released the iteration a request finishes (the continuous-batching
  engine).  Every block is a :class:`~repro_torch.core.arena.SlabPool` slab,
  so blocks freed by one request immediately back another (§3.2
  cross-arena reuse) and admission can run against the pool's *actual*
  headroom instead of lifetime upper bounds.

:class:`BlockKVCache` optionally fronts a **host-memory block tier**
(``host_budget_bytes > 0``): a preempted slot's written blocks move to
a refcounted host store (spill) instead of being discarded, and
re-admission *restores* them — zero re-prefilled tokens, bit-identical
resumed streams (a device->host->device round trip of same-dtype
arrays is exact).  The cache plans and accounts the movement
(spill_plan / commit_spill / restore); the engine owns the actual
device transfers, mirroring how hetero/transfer.py separates planned
byte accounting from execution.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.arena import SlabPool, _align

from .telemetry import MetricsRegistry


def kv_bytes_per_token(cfg) -> int:
    """Per-token, per-sequence KV bytes (the shape-inference step)."""
    hd = cfg.resolved_head_dim()
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            total += 2 * cfg.num_kv_heads * hd * itemsize
    return total


def state_bytes(cfg) -> int:
    """Per-sequence constant state bytes (SSM state + conv window)."""
    if cfg.ssm.d_state == 0:
        return 0
    d_inner = cfg.ssm.expand * cfg.d_model
    nheads = d_inner // cfg.ssm.head_dim
    conv_dim = d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    n_ssm = sum(1 for i in range(cfg.num_layers)
                if not cfg.is_attn_layer(i))
    per_layer = (nheads * cfg.ssm.head_dim * cfg.ssm.d_state * 4
                 + (cfg.ssm.conv_width - 1) * conv_dim * 2)
    return n_ssm * per_layer


def request_peak_bytes(cfg, context_len: int) -> int:
    """M_i of one request (paper §3.3 branch peak-memory estimate)."""
    attn_len = context_len
    if cfg.sliding_window:
        attn_len = min(context_len, cfg.sliding_window)
    return kv_bytes_per_token(cfg) * attn_len + state_bytes(cfg)


@dataclass
class CacheLease:
    request_id: int
    slab_id: int
    nbytes: int


class _HostEntry:
    """One block's payload in the host tier, refcounted across the
    spilled slots that reference it (a prefix block shared by three
    spilled requests is captured and charged exactly once)."""

    __slots__ = ("data", "refs")

    def __init__(self, data):
        self.data = data
        self.refs = 1


@dataclass
class SpillPlan:
    """A pure plan for moving one slot's written blocks to the host
    tier: ``entries`` is ``[(key, slab_id, need_capture), ...]`` in
    block-table order, where ``key`` is the block's chain hash (bytes,
    registered prefix blocks — dedups across spilled siblings) or a
    per-request private tuple, and ``need_capture`` marks keys whose
    payload is not in the host store yet.  Planning allocates nothing;
    the engine captures ``capture_ids`` device->host and then calls
    :meth:`BlockKVCache.commit_spill`."""

    slot: int
    request_id: int
    n_tokens: int
    entries: "list[tuple]"

    @property
    def capture_ids(self) -> "list[int]":
        return [sid for _, sid, need in self.entries if need]


@dataclass
class _SpillRecord:
    """Host-tier residency of one preempted request: the block keys in
    table order plus the publish watermark/chain hash needed to resume
    bookkeeping exactly where the slot left off."""

    keys: "list"
    n_tokens: int
    published: int
    chain: bytes


class KVCacheManager:
    """Slab-pooled per-request cache accounting under an HBM budget."""

    def __init__(self, cfg, budget_bytes: int):
        self.cfg = cfg
        self.budget = budget_bytes
        self.pool = SlabPool()
        self.leases: dict[int, CacheLease] = {}
        self._slabs: dict[int, object] = {}

    def can_admit(self, context_len: int) -> bool:
        need = request_peak_bytes(self.cfg, context_len)
        return self.pool.in_use + need <= self.budget

    def admit(self, request_id: int, context_len: int) -> CacheLease:
        need = request_peak_bytes(self.cfg, context_len)
        if self.pool.in_use + need > self.budget:
            raise MemoryError(
                f"request {request_id}: {need} bytes exceeds budget head"
                f"room ({self.budget - self.pool.in_use})")
        slab = self.pool.acquire(need)
        lease = CacheLease(request_id, slab.id, slab.size)
        self.leases[request_id] = lease
        self._slabs[request_id] = slab
        return lease

    def release(self, request_id: int) -> None:
        slab = self._slabs.pop(request_id)
        self.pool.release(slab)
        del self.leases[request_id]

    @property
    def in_use(self) -> int:
        return self.pool.in_use

    @property
    def peak_bytes(self) -> int:
        return self.pool.peak_bytes

    @property
    def reuse_count(self) -> int:
        return self.pool.reuse_count


# --------------------------------------------------------------------------
# block-granular cache (continuous batching)
# --------------------------------------------------------------------------

class BlockKVCache:
    """Per-slot block tables over a slab pool of fixed-size KV blocks.

    A *block* covers ``block_size`` token positions of every attention
    layer's K and V for one sequence; blocks are acquired lazily as a
    slot's sequence crosses block boundaries and all released the
    iteration the request finishes.  SSM/conv state is context-length
    independent, so each slot additionally holds one constant-size
    *state slab* for its lifetime.  All storage is accounted through one
    :class:`SlabPool`: since blocks are uniform-size, every block a
    finished (or preempted) request frees is a perfect best-fit for the
    next grower — cross-request reuse shows up as ``pool.reuse_count``.

    **Physical block ids.**  Because KV slabs are uniform-size, a slab's
    ``id`` doubles as a *physical row index* into the per-layer block
    pools allocated by ``models.attention.init_paged_kv_cache``: ids are
    handed out densely from 0 and reused through the pool, so the peak
    concurrent block count bounds the highest id ever issued.
    ``table_ids(slot)`` is the slot's physical block table the engine
    ships to the traced step functions.

    **Prefix sharing.**  ``admit(..., tokens=...)`` content-hashes the
    prompt's *full* blocks (a chain hash, so equality means an identical
    prefix from position 0) and maps matching blocks of concurrently
    live requests to the same physical block — refcounted, immutable,
    charged against the budget exactly once.  ``publish`` registers a
    slot's own full prompt blocks once prefill has actually written
    them; ``free`` drops refs and only returns a block to the pool (and
    the hash registry) when its last holder leaves.  Shared blocks are
    copy-on-write-by-construction: a block is only ever shareable once
    full and is never written again (``check_write`` enforces this, and
    the sharing cap in ``admit`` keeps every row's first written
    position past its shared prefix).

    **Persistent prefix cache** (``prefix_cache=True``).  Chain-hash
    registrations form a radix tree over physical rows: each registered
    hash's parent is the hash one block shorter (root ``b"kv0"``), kept
    in ``_parent``/``_children``.  When a finished slot's ``free`` drops
    the LAST reference on a *registered* block, the block is not
    released — it moves to the cache tier (``_cached``: hash -> LRU
    tick, zero live holders, still registered, still charged against
    the budget).  A later ``admit`` whose prompt walk reaches a cached
    hash *revives* the block in place — the physical row is mapped into
    the new table and those tokens skip prefill entirely, even though
    no live request held them in between.  Eviction pops the
    least-recently-cached **leaf** (a cached hash with no registered
    children — interior nodes with live or cached descendants are
    structurally never evictable first) whenever the pool needs bytes
    (admission/growth/restore shortfall, a runtime budget shrink, or a
    physical ``row_cap`` hit), so cold cache yields to live work,
    deterministically: the tick order is completion order.  With the
    host tier armed, an evicted block gets a second chance: its payload
    is captured to the host pool (``_host_lru``, refcount 0) and an
    admission walk that misses the device tree can still revive it
    through one host->device scatter instead of re-prefilling.
    """

    def __init__(self, cfg, budget_bytes: int, block_size: int = 16,
                 metrics=None, host_budget_bytes: int = 0,
                 prefix_cache: bool = False):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if host_budget_bytes < 0:
            raise ValueError(f"host budget must be >= 0, "
                             f"got {host_budget_bytes}")
        self.cfg = cfg
        self.budget = budget_bytes
        self.block_size = block_size
        per_tok = kv_bytes_per_token(cfg)
        sb = state_bytes(cfg)
        self.block_bytes = _align(per_tok * block_size) if per_tok else 0
        self.state_bytes = _align(sb) if sb else 0
        # KV blocks and state slabs live in SEPARATE pools: SlabPool's
        # best-fit hands out any slab >= the request, so on hybrid
        # attention+SSM archs a freed state slab could otherwise satisfy
        # a (smaller) block request and silently charge more bytes than
        # the headroom check accounted for.
        self.pool = SlabPool()                      # uniform KV blocks
        self.state_pool = SlabPool()                # uniform state slabs
        self._peak = 0
        self.block_tables: "dict[int, list]" = {}   # slot -> [Slab, ...]
        self.state_slabs: "dict[int, object]" = {}  # slot -> Slab
        # prefix sharing: refcounts + content-hash registry
        self._ref: "dict[int, int]" = {}            # slab id -> holders
        self._registry: "dict[bytes, object]" = {}  # chain hash -> Slab
        self._slab_hash: "dict[int, bytes]" = {}    # slab id -> chain hash
        self._published: "dict[int, int]" = {}      # slot -> #blocks hashed
        self._chain: "dict[int, bytes]" = {}        # slot -> hash at mark
        # persistent prefix cache: radix-tree links over registered
        # hashes + the LRU tier of retained zero-holder blocks.  Sound
        # only for block-granular KV with no per-row state (same gating
        # as the host tier: SSM/conv state cannot outlive its slot).
        self.prefix_cache = (bool(prefix_cache) and self.block_bytes > 0
                             and self.state_bytes == 0)
        self._parent: "dict[bytes, bytes]" = {}     # hash -> parent hash
        self._children: "dict[bytes, set]" = {}     # hash -> child hashes
        self._cached: "dict[bytes, int]" = {}       # hash -> LRU tick
        self._lru_tick = 0
        self._host_lru: "dict[object, int]" = {}    # host-cached -> tick
        #: physical row cap of the paged pools (engine-injected); a
        #: fresh acquisition that would mint a row past the cap evicts
        #: a cached row instead of corrupting paged indexing.  None =
        #: unbounded (direct cache use without paged pools).
        self.row_cap: "int | None" = None
        #: engine-injected transfer hooks for the host second-chance
        #: tier: capture(ids) -> {id: payload}, scatter([(id, payload)])
        self.capture_hook = None
        self.scatter_hook = None
        #: optional span recorder (engine-injected) for cache_evict
        #: points; never consulted for decisions
        self.rec = None
        # host block tier: spilled payloads keyed by chain hash (shared
        # prefix blocks) or a per-request private key — restoring costs
        # only the blocks no live slot still registers.  Spill/restore
        # moves whole written-token state, so the tier is only sound
        # when that state lives entirely in the KV blocks: any per-row
        # SSM/conv state would be lost by free().  Same gating shape as
        # prefix sharing (engine mirrors it).
        self.host_budget = host_budget_bytes
        self._host: "dict[object, _HostEntry]" = {}
        self._host_in_use = 0
        self._host_peak = 0
        self._spilled: "dict[int, _SpillRecord]" = {}  # request id -> rec
        # typed metrics (registry shared with the owning engine when
        # given); legacy counter attributes remain readable as the
        # property façade below
        m = metrics if metrics is not None else MetricsRegistry()
        self.metrics = m
        self._m_acquired = m.counter("kv.blocks_acquired")
        self._m_released = m.counter("kv.blocks_released")
        self._m_shared_hits = m.counter("kv.shared_block_hits")
        self._m_prompt_acquired = m.counter("kv.prompt_blocks_acquired")
        self._g_blocks = m.gauge("kv.blocks_live")
        self._g_bytes = m.gauge("kv.bytes_in_use")
        # host-tier transfer accounting (spill/restore byte counters
        # feed the telemetry plane's trace; gauges carry high-water)
        self._m_spilled_blocks = m.counter("kv.blocks_spilled")
        self._m_restored_blocks = m.counter("kv.blocks_restored")
        self._m_spill_bytes = m.counter("kv.spill_bytes")
        self._m_restore_bytes = m.counter("kv.restore_bytes")
        self._m_spill_shared = m.counter("kv.spill_shared_hits")
        self._g_host_blocks = m.gauge("kv.host_blocks_live")
        self._g_host_bytes = m.gauge("kv.host_bytes_in_use")
        # persistent prefix cache flow: device revives, host-tier
        # revives, and LRU evictions from each tier
        self._m_cache_hits = m.counter("kv.prefix_cache_hits")
        self._m_cache_host_hits = m.counter("kv.prefix_cache_host_hits")
        self._m_cache_evictions = m.counter("kv.prefix_cache_evictions")
        self._m_cache_host_evictions = \
            m.counter("kv.prefix_cache_host_evictions")
        self._g_cached = m.gauge("kv.prefix_cache_blocks")

    # -- metric façade (legacy attribute names) -----------------------------

    @property
    def shared_block_hits(self) -> int:
        """Blocks mapped to an existing physical block instead of
        allocated (prefix sharing)."""
        return self._m_shared_hits.value

    @property
    def acquired_blocks(self) -> int:
        """Cumulative pool acquisitions."""
        return self._m_acquired.value

    @property
    def prompt_blocks_acquired(self) -> int:
        """Admit-time subset of ``acquired_blocks`` (vs growth)."""
        return self._m_prompt_acquired.value

    @property
    def live_blocks(self) -> int:
        """Physical KV blocks currently held (shared blocks count once,
        cache-tier retained blocks included) — the pool-occupancy
        gauge's instantaneous value."""
        return len(self._ref) + len(self._cached)

    @property
    def prefix_cache_hits(self) -> int:
        """Blocks revived from the persistent cache (device tier)."""
        return self._m_cache_hits.value

    @property
    def prefix_cache_host_hits(self) -> int:
        """Blocks revived from the host second-chance tier."""
        return self._m_cache_host_hits.value

    @property
    def prefix_cache_hit_blocks(self) -> int:
        """Total cache-attributable revivals (device + host tiers) —
        blocks whose tokens skipped prefill with no live holder."""
        return self._m_cache_hits.value + self._m_cache_host_hits.value

    @property
    def prefix_cache_evictions(self) -> int:
        return self._m_cache_evictions.value

    @property
    def cached_blocks(self) -> int:
        """Blocks currently retained by the cache tier (zero holders)."""
        return len(self._cached)

    @property
    def evictable_bytes(self) -> int:
        """Device bytes reclaimable RIGHT NOW by repeated leaf-first
        eviction — reported to the scheduler as reclaimable headroom so
        admission never stalls behind cold cache.  A cached block that
        is an *ancestor* of a live registered block is excluded: it
        stays pinned in the tree until its live descendants resolve
        (possible only when a concurrent-prefill race published a child
        under another request's registered parent), so counting it
        would let admission overcommit and hit a surprise MemoryError."""
        if not self._cached:
            return 0
        pinned: "set[bytes]" = set()
        for sid, h in self._slab_hash.items():
            if self._ref.get(sid, 0) > 0:
                p = self._parent.get(h)
                while p is not None and p not in pinned:
                    pinned.add(p)
                    p = self._parent.get(p)
        n = sum(1 for h in self._cached if h not in pinned)
        return n * self.block_bytes

    def _track(self) -> None:
        """Refresh the occupancy gauges after any allocation/release;
        gauges carry a high-water mark, so this is also where peak
        occupancy is captured."""
        self._g_blocks.set(len(self._ref) + len(self._cached))
        self._g_bytes.set(self.in_use)
        self._g_cached.set(len(self._cached))

    def _track_host(self) -> None:
        self._host_peak = max(self._host_peak, self._host_in_use)
        self._g_host_blocks.set(len(self._host))
        self._g_host_bytes.set(self._host_in_use)

    # -- shape inference ----------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        if self.block_bytes == 0:
            return 0
        return -(-max(n_tokens, 0) // self.block_size)

    def bytes_for(self, n_tokens: int) -> int:
        """Admission cost of a fresh slot holding ``n_tokens`` (prompt
        blocks + the constant state slab) — what `incremental_select`
        charges against the pool's live headroom."""
        return self.blocks_for(n_tokens) * self.block_bytes \
            + self.state_bytes

    @property
    def headroom(self) -> int:
        """May be NEGATIVE after a runtime budget shrink — every
        admission/growth path treats it as "no room" (blocks_for * bytes
        can never be < 0), so a shrunk pool refuses growth until enough
        blocks drain or the budget is restored."""
        return self.budget - self.in_use

    @property
    def host_enabled(self) -> bool:
        """The host block tier is armed and sound for this arch: a
        positive host budget, block-granular KV, and NO per-row state
        (SSM/conv state cannot ride the block spill — hybrid archs keep
        demote-only preemption)."""
        return (self.host_budget > 0 and self.block_bytes > 0
                and self.state_bytes == 0)

    @property
    def host_headroom(self) -> int:
        return self.host_budget - self._host_in_use

    @property
    def host_in_use(self) -> int:
        return self._host_in_use

    @property
    def host_peak_bytes(self) -> int:
        return self._host_peak

    @property
    def host_blocks_live(self) -> int:
        return len(self._host)

    def set_budget(self, budget_bytes: int) -> None:
        """Adjust the pool budget at runtime (co-tenant memory pressure,
        driven by the fault plane).  The new budget may be BELOW the
        bytes currently in use: no *live* block is ever evicted here —
        the engine reacts by refusing admission/growth and
        demote-preempting until ``in_use`` fits again.  With the
        persistent prefix cache enabled, cold cached blocks are LRU-
        evicted FIRST (second-chanced to the host tier when armed), so
        a shrink only ever demotes live requests once the cache tier is
        empty."""
        if budget_bytes < 0:
            raise ValueError(f"budget must be >= 0, got {budget_bytes}")
        self.budget = budget_bytes
        self._shrink_to_budget()

    @property
    def in_use(self) -> int:
        return self.pool.in_use + self.state_pool.in_use

    @property
    def peak_bytes(self) -> int:
        return self._peak

    @property
    def reuse_count(self) -> int:
        return self.pool.reuse_count + self.state_pool.reuse_count

    def capacity_tokens(self, slot: int) -> int:
        """Token positions the slot's current block table covers."""
        if self.block_bytes == 0:
            return 1 << 62                       # stateful archs: unbounded
        return len(self.block_tables[slot]) * self.block_size

    # -- lifecycle ----------------------------------------------------------

    def _chain_step(self, h: bytes, tokens, i: int) -> bytes:
        """Extend a chain hash by full block ``i`` of ``tokens``: the
        result commits to every token in blocks 0..i, so equal hashes
        mean an identical prefix from position 0 (absolute positions —
        and hence RoPE — included by construction)."""
        blk = np.ascontiguousarray(
            tokens[i * self.block_size:(i + 1) * self.block_size],
            np.int32)
        return hashlib.sha1(h + blk.tobytes()).digest()

    def _acquire_block(self):
        if self._cached and self.row_cap is not None:
            # no free slab and the pool is at its physical row cap: a
            # fresh acquire would mint a slab id past the paged pools'
            # rows — recycle cached rows instead of corrupting indexing
            while (self.pool.total_allocated - self.pool.in_use
                    < self.block_bytes
                    and self.pool.total_allocated
                    >= self.row_cap * self.block_bytes):
                if not self._evict_one():
                    break
        slab = self.pool.acquire(self.block_bytes)
        self._ref[slab.id] = 1
        self._m_acquired.inc()
        return slab

    # -- persistent prefix cache (radix tree + LRU tier) --------------------

    def _tick(self) -> int:
        t = self._lru_tick
        self._lru_tick += 1
        return t

    def _link(self, parent: bytes, child: bytes) -> None:
        """Record a radix-tree edge at (re-)registration time."""
        if not self.prefix_cache:
            return
        self._parent[child] = parent
        self._children.setdefault(parent, set()).add(child)

    def _unlink(self, h: bytes) -> None:
        p = self._parent.pop(h, None)
        if p is not None:
            kids = self._children.get(p)
            if kids is not None:
                kids.discard(h)
                if not kids:
                    del self._children[p]

    def _share(self, slab) -> None:
        """Take a reference on a registered block: a live share, or a
        revival of a cache-tier block (zero holders -> one)."""
        h = self._slab_hash.get(slab.id)
        if h is not None and h in self._cached:
            del self._cached[h]
            self._ref[slab.id] = 1
            self._m_cache_hits.inc()
        else:
            self._ref[slab.id] += 1
        self._m_shared_hits.inc()

    def _evict_one(self, protect=frozenset()) -> bool:
        """Drop the least-recently-cached LEAF from the device tier.

        Only leaves are candidates: a cached hash with a registered
        child is interior (and by table contiguity a cached hash never
        has a *live* child — any live holder of the child also holds
        the parent).  Ties cannot occur (ticks are unique), so eviction
        order is a pure function of completion order: deterministic.
        With the host tier armed and transfer hooks attached, the
        payload is captured host-side (second chance) before the device
        row is released.  Returns False when nothing is evictable."""
        best = None
        for h, tick in self._cached.items():
            if h in protect or self._children.get(h):
                continue
            if best is None or tick < self._cached[best]:
                best = h
        if best is None:
            return False
        slab = self._registry.pop(best)
        del self._slab_hash[slab.id]
        del self._cached[best]
        self._unlink(best)
        to_host = False
        if (self.host_enabled and self.capture_hook is not None
                and best not in self._host):
            while self.block_bytes > self.host_headroom \
                    and self._host_lru:
                self._evict_host_one()
            if self.block_bytes <= self.host_headroom:
                ent = _HostEntry(self.capture_hook([slab.id])[slab.id])
                ent.refs = 0
                self._host[best] = ent
                self._host_in_use += self.block_bytes
                self._host_lru[best] = self._tick()
                self._track_host()
                to_host = True
        self.pool.release(slab)
        self._m_released.inc()
        self._m_cache_evictions.inc()
        if self.rec is not None:
            self.rec.point("cache_evict", block=slab.id,
                           bytes=self.block_bytes, to_host=to_host)
        self._track()
        return True

    def _evict_host_one(self) -> bool:
        """Drop the LRU host-cached payload (refcount 0 — never a
        spill-record pin).  Host entries carry no sharing semantics, so
        no leaf discipline is needed; an orphaned child key simply ages
        out unreachable."""
        if not self._host_lru:
            return False
        h = min(self._host_lru, key=self._host_lru.get)
        del self._host_lru[h]
        del self._host[h]
        self._host_in_use -= self.block_bytes
        self._m_cache_host_evictions.inc()
        self._track_host()
        return True

    def _reclaim(self, need: int, protect=frozenset()) -> None:
        """Evict cached blocks until ``need`` bytes fit in headroom (or
        the tier is dry).  ``protect`` pins hashes an in-flight
        admission is about to revive."""
        while need > self.headroom and self._cached:
            if not self._evict_one(protect):
                break

    def _reclaim_host(self, need: int) -> None:
        while need > self.host_headroom and self._host_lru:
            self._evict_host_one()

    def _shrink_to_budget(self) -> None:
        while self.in_use > self.budget and self._cached:
            if not self._evict_one():
                break

    def clear_cache(self) -> None:
        """Evict every cache-tier block (drains the radix tree;
        leaf-first order makes full drain always reachable)."""
        while self._cached:
            if not self._evict_one():
                break

    def evict_cached(self) -> bool:
        """Public single-step eviction — the engine's cheapest
        reclamation rung (nothing live demotes).  False when the tier
        is empty or every cached block is pinned under a live child."""
        return self._evict_one()

    def reclaim_cached(self, need: int, protect_spill=None) -> None:
        """Evict cache-tier blocks until ``need`` bytes fit in headroom
        (or nothing more is evictable).  ``protect_spill`` names a
        spilled request whose still-registered keys an imminent restore
        will share — those are pinned, exactly as :meth:`restore`'s own
        internal reclaim pins them, so a caller that checks headroom
        after this can trust restore not to raise."""
        protect = frozenset()
        if protect_spill is not None and protect_spill in self._spilled:
            protect = frozenset(
                k for k in self._spilled[protect_spill].keys
                if isinstance(k, bytes) and k in self._registry)
        self._reclaim(need, protect)

    def admit(self, slot: int, n_tokens: int, tokens=None) -> int:
        """Allocate a fresh slot's prompt blocks + state slab.

        With ``tokens`` (the pending prompt, length ``n_tokens``) given,
        full prompt blocks whose chain hash is registered by a live
        request are *shared* instead of allocated: the slot's table maps
        them to the existing physical blocks (refcounted) and only the
        remainder is charged.  Sharing is capped below the block holding
        the prompt's LAST position — that position must be recomputed to
        produce the first generated token's logits, and the cap keeps
        every write this slot will ever issue strictly above its shared
        prefix (copy-on-write never triggers; check_write enforces).

        With the persistent prefix cache, the walk additionally revives
        matching cache-tier blocks (zero live holders) in place, and —
        when the host second-chance tier is armed — continues through
        host-resident payloads, scattering them back onto fresh device
        rows.  Cold cached blocks are LRU-evicted if the remainder does
        not fit the raw headroom.

        Returns the number of prefix tokens already present in the
        cache (a multiple of ``block_size``; 0 without sharing) — the
        engine starts prefill *after* them.
        """
        assert slot not in self.block_tables, f"slot {slot} already live"
        shared, chain = [], b"kv0"
        host_hits: "list[tuple]" = []       # (hash, parent hash)
        if tokens is not None and self.block_bytes and n_tokens > 1:
            assert len(tokens) == n_tokens, (len(tokens), n_tokens)
            limit = (n_tokens - 1) // self.block_size
            for i in range(limit):
                h = self._chain_step(chain, tokens, i)
                slab = self._registry.get(h)
                # the registered set is ancestor-closed (leaf-first
                # eviction), so device hits always precede host hits;
                # the guard keeps table order token order regardless
                if slab is not None and not host_hits:
                    shared.append(slab)
                    chain = h
                    continue
                ent = self._host.get(h)
                if (self.prefix_cache and self.scatter_hook is not None
                        and ent is not None and ent.refs == 0):
                    host_hits.append((h, chain))
                    chain = h
                    continue
                break
        fresh = self.blocks_for(n_tokens) - len(shared) - len(host_hits)
        need = (fresh + len(host_hits)) * self.block_bytes \
            + self.state_bytes
        # pin the host hits against host-LRU eviction, and the matched
        # device hashes against the reclaim below, while we make room
        pinned = {h: self._host_lru.pop(h) for h, _ in host_hits}
        self._reclaim(need, protect=frozenset(
            self._slab_hash[s.id] for s in shared
            if s.id in self._slab_hash))
        if need > self.headroom:
            self._host_lru.update(pinned)   # un-pin: nothing admitted
            raise MemoryError(
                f"slot {slot}: {need} bytes exceeds block-pool headroom "
                f"({self.headroom})")
        for slab in shared:
            self._share(slab)
        table = list(shared)
        scatter = []
        for h, parent in host_hits:
            slab = self._acquire_block()
            ent = self._host.pop(h)
            self._host_in_use -= self.block_bytes
            scatter.append((slab.id, ent.data))
            self._registry[h] = slab
            self._slab_hash[slab.id] = h
            self._link(parent, h)
            self._m_cache_host_hits.inc()
            table.append(slab)
        if scatter:
            self.scatter_hook(scatter)
            self._track_host()
        table.extend(self._acquire_block() for _ in range(fresh))
        self.block_tables[slot] = table
        self._m_prompt_acquired.inc(fresh + len(host_hits))
        if self.state_bytes:
            self.state_slabs[slot] = \
                self.state_pool.acquire(self.state_bytes)
        self._published[slot] = len(shared) + len(host_hits)
        self._chain[slot] = chain          # hash at the published mark
        self._peak = max(self._peak, self.in_use)
        self._track()
        return (len(shared) + len(host_hits)) * self.block_size

    def publish(self, slot: int, tokens, n_filled: int) -> None:
        """Register the slot's full prompt blocks entirely covered by
        the first ``n_filled`` *written* cache positions, making them
        shareable by later admissions.  Blocks already registered (e.g.
        the slot's own shared prefix) are skipped; blocks holding
        generated tokens are never registered (``tokens`` is the pending
        prompt, so the cap is its length)."""
        if not self.block_bytes:
            return
        full = min(int(n_filled), len(tokens)) // self.block_size
        start = self._published.get(slot, 0)
        if full <= start:
            return
        table = self.block_tables[slot]
        chain = self._chain.get(slot, b"kv0")   # hash at ``start`` blocks
        for i in range(start, full):
            parent = chain
            chain = self._chain_step(chain, tokens, i)
            if chain not in self._registry:
                slab = table[i]
                self._registry[chain] = slab
                self._slab_hash[slab.id] = chain
                self._link(parent, chain)
        self._published[slot] = full
        self._chain[slot] = chain

    def check_write(self, slot: int, start: int, stop: int) -> None:
        """Assert positions ``start..stop-1`` of the slot are writable:
        every covered block is private (refcount 1) and unregistered.
        The engine calls this before each dispatch that writes — a
        violation means the sharing cap or publish watermark broke, and
        writing through would corrupt another request's cache."""
        if not self.block_bytes or stop <= start:
            return
        table = self.block_tables[slot]
        for i in range(start // self.block_size,
                       (stop - 1) // self.block_size + 1):
            slab = table[i]
            if self._ref[slab.id] > 1 or slab.id in self._slab_hash:
                raise RuntimeError(
                    f"write-through to shared block: slot {slot} "
                    f"positions [{start}, {stop}) hit block {slab.id} "
                    f"(ref={self._ref[slab.id]}, "
                    f"registered={slab.id in self._slab_hash})")

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Extend the slot's block table to cover ``n_tokens`` positions
        — the *bulk reserve* half of the megastep protocol: the engine
        reserves every block an N-step decode megastep could write
        BEFORE launching the scan (which itself can never allocate).
        Returns False (allocating nothing) when the pool lacks headroom —
        the engine then preempts and retries, or launches a shorter
        megastep."""
        table = self.block_tables[slot]
        extra = self.blocks_for(n_tokens) - len(table)
        if extra <= 0:
            return True
        if extra * self.block_bytes > self.headroom:
            # cold cache yields before growth is refused (and the
            # caller demote-preempts a live request)
            self._reclaim(extra * self.block_bytes)
            if extra * self.block_bytes > self.headroom:
                return False
        table.extend(self._acquire_block() for _ in range(extra))
        self._peak = max(self._peak, self.in_use)
        self._track()
        return True

    def release_to(self, slot: int, n_tokens: int) -> int:
        """Return the slot's blocks beyond ``blocks_for(n_tokens)`` to
        the pool — the *bulk release* half of the megastep protocol:
        after the scan returns, blocks reserved for steps a row never
        took (EOS fired early, budget emptied mid-scan) go straight back
        so the next admission/growth sees the true headroom.  Reserved
        blocks are trailing, private (refcount 1) and unregistered by
        construction — prefix-shared blocks live strictly below every
        write position and are never reserved.  Returns the number of
        blocks released."""
        if not self.block_bytes:
            return 0
        table = self.block_tables[slot]
        keep = self.blocks_for(n_tokens)
        freed = 0
        while len(table) > keep:
            slab = table.pop()
            assert self._ref[slab.id] == 1 \
                and slab.id not in self._slab_hash, \
                f"reserved block {slab.id} became shared"
            del self._ref[slab.id]
            self.pool.release(slab)
            freed += 1
        if freed:
            self._m_released.inc(freed)
            self._track()
        return freed

    def free(self, slot: int) -> None:
        """Drop the slot's reference on every block (+ release the state
        slab) the iteration a request finishes or is preempted.  A block
        returns to the pool — §3.2 cross-request reuse — only when its
        LAST holder leaves; its hash registration is dropped at the same
        moment (sharing engages among concurrently live requests).

        With ``prefix_cache`` enabled, a *registered* block whose last
        holder leaves is retained by the cache tier instead (LRU-
        stamped in table order, so deeper blocks — the tree's leaves —
        carry later ticks): a later admission with the same prefix
        revives it and skips prefill.  Unregistered blocks (partial
        last prompt block, generated tokens) release as before."""
        freed = 0
        for slab in self.block_tables.pop(slot):
            self._ref[slab.id] -= 1
            if self._ref[slab.id] == 0:
                del self._ref[slab.id]
                h = self._slab_hash.get(slab.id)
                if h is not None and self.prefix_cache:
                    self._cached[h] = self._tick()
                    continue
                if h is not None:
                    del self._slab_hash[slab.id]
                    del self._registry[h]
                self.pool.release(slab)
                freed += 1
        state = self.state_slabs.pop(slot, None)
        if state is not None:
            self.state_pool.release(state)
        self._published.pop(slot, None)
        self._chain.pop(slot, None)
        self._m_released.inc(freed)
        self._track()
        if self.in_use > self.budget:
            # a shrunk budget outlives the live blocks that pinned it:
            # the moment they demote to cache they become evictable
            self._shrink_to_budget()

    # -- host block tier (spill / restore) ----------------------------------

    def spill_plan(self, slot: int, request_id: int,
                   n_tokens: int) -> "SpillPlan | None":
        """Plan moving the slot's first ``blocks_for(n_tokens)`` blocks
        (exactly the written watermark — reserved-but-unwritten trailing
        blocks are never spilled, they just return to the pool) to the
        host tier.  Pure: allocates and frees nothing.  Returns None
        when the tier is disabled or lacks room for the payloads not
        already resident (the engine then demote-discards as before)."""
        if not self.host_enabled:
            return None
        assert request_id not in self._spilled, \
            f"request {request_id} already spilled"
        table = self.block_tables[slot]
        nb = self.blocks_for(n_tokens)
        assert len(table) >= nb, (len(table), nb)
        entries: "list[tuple]" = []
        fresh = 0
        for i in range(nb):
            slab = table[i]
            h = self._slab_hash.get(slab.id)
            key = h if h is not None else ("p", request_id, i)
            need = key not in self._host
            entries.append((key, slab.id, need))
            fresh += need
        if fresh * self.block_bytes > self.host_headroom:
            # a live spill outranks cold host-cached payloads: drop the
            # LRU ones to make room (the only impurity of this plan —
            # it still allocates nothing device-side)
            self._reclaim_host(fresh * self.block_bytes)
            if fresh * self.block_bytes > self.host_headroom:
                return None
        return SpillPlan(slot, request_id, n_tokens, entries)

    def commit_spill(self, plan: "SpillPlan", data: dict) -> int:
        """Charge the host tier and record the spilled slot.  ``data``
        maps each ``plan.capture_ids`` slab id to its captured payload
        (opaque to the cache — the engine read it off the device).
        Payloads already resident (spilled siblings sharing a prefix)
        are refcounted, not duplicated — a block shared by three
        requests spills ONCE.  The caller must still free the slot
        (``free``) afterwards; returns the bytes newly written to the
        host tier."""
        slot, rid = plan.slot, plan.request_id
        spilled = 0
        for key, slab_id, need in plan.entries:
            ent = self._host.get(key)
            if ent is None:
                assert need and slab_id in data, \
                    f"plan/capture mismatch for block {slab_id}"
                self._host[key] = _HostEntry(data[slab_id])
                self._host_in_use += self.block_bytes
                spilled += self.block_bytes
                self._m_spilled_blocks.inc()
            else:
                if ent.refs == 0:
                    # host-cached (second-chance) payload: the spill
                    # record pins it out of the host LRU ring
                    self._host_lru.pop(key, None)
                ent.refs += 1
                self._m_spill_shared.inc()
        self._m_spill_bytes.inc(spilled)
        self._spilled[rid] = _SpillRecord(
            keys=[k for k, _, _ in plan.entries],
            n_tokens=plan.n_tokens,
            published=self._published.get(slot, 0),
            chain=self._chain.get(slot, b"kv0"))
        self._track_host()
        return spilled

    def has_spill(self, request_id: int) -> bool:
        return request_id in self._spilled

    def spilled_tokens(self, request_id: int) -> int:
        return self._spilled[request_id].n_tokens

    def restore_bytes(self, request_id: int) -> int:
        """Device bytes a restore must allocate NOW: blocks whose chain
        hash a live slot still registers are shared (free); the rest
        need fresh device blocks.  This is the admission cost of a
        spilled request — typically far below ``bytes_for``."""
        rec = self._spilled[request_id]
        fresh = sum(1 for k in rec.keys
                    if not (isinstance(k, bytes) and k in self._registry))
        return fresh * self.block_bytes + self.state_bytes

    def restore(self, slot: int, request_id: int):
        """Rebuild the slot's device block table from the host tier.
        Blocks still registered by a live slot are shared (refcounted,
        no transfer — a shared prefix restores ONCE even across spilled
        siblings); the rest get fresh device blocks the engine must
        fill from the returned scatter list.  The publish watermark and
        chain hash resume exactly where the slot left off, so COW
        invariants survive the round trip.  Returns ``(n_tokens,
        scatter)`` with ``scatter = [(slab_id, payload), ...]``."""
        assert slot not in self.block_tables, f"slot {slot} already live"
        protect = frozenset(
            k for k in self._spilled[request_id].keys
            if isinstance(k, bytes) and k in self._registry)
        need = self.restore_bytes(request_id)
        self._reclaim(need, protect)
        if need > self.headroom:
            raise MemoryError(
                f"request {request_id}: restore needs {need} bytes, "
                f"headroom is {self.headroom}")
        rec = self._spilled.pop(request_id)
        # revive/ref every still-registered key FIRST so the fresh-block
        # acquisitions below (which may row-cap-evict cache-tier blocks)
        # can never race the shares away
        shares = {}
        for key in rec.keys:
            if isinstance(key, bytes):
                slab = self._registry.get(key)
                if slab is not None:
                    self._share(slab)
                    shares[key] = slab
        table, scatter = [], []
        restored = 0
        prev = b"kv0"
        for key in rec.keys:
            ent = self._host[key]
            slab = shares.get(key)
            if slab is None:
                slab = self._acquire_block()
                scatter.append((slab.id, ent.data))
                restored += 1
                if isinstance(key, bytes):
                    # re-register restored prefix blocks so spilled
                    # siblings and later admissions share them again
                    self._registry[key] = slab
                    self._slab_hash[slab.id] = key
                    self._link(prev, key)
            table.append(slab)
            if isinstance(key, bytes):
                prev = key
            ent.refs -= 1
            if ent.refs == 0:
                del self._host[key]
                self._host_in_use -= self.block_bytes
        self.block_tables[slot] = table
        self._published[slot] = rec.published
        self._chain[slot] = rec.chain
        self._m_restored_blocks.inc(restored)
        self._m_restore_bytes.inc(restored * self.block_bytes)
        self._peak = max(self._peak, self.in_use)
        self._track()
        self._track_host()
        return rec.n_tokens, scatter

    def drop_spill(self, request_id: int) -> None:
        """Release a spilled request's host residency without restoring
        (cancel / deadline / run-cap failure while demoted)."""
        rec = self._spilled.pop(request_id, None)
        if rec is None:
            return
        for key in rec.keys:
            ent = self._host[key]
            ent.refs -= 1
            if ent.refs == 0:
                del self._host[key]
                self._host_in_use -= self.block_bytes
        self._track_host()

    def assert_quiescent(self) -> None:
        """Assert the pool is drained of LIVE state: no block tables or
        state slabs, no refcounts, no publish watermarks, no spill
        records.  This is the zero-leak invariant every engine run must
        restore once all requests resolve (completed, cancelled,
        rejected or failed) — the chaos suite calls it after every fault
        schedule, and the engine tests after every run, so a single
        leaked block anywhere in the admit/grow/release_to/free
        lifecycle fails loudly instead of silently shrinking the pool.

        The persistent prefix cache may legitimately be NON-empty at
        drain — that is its whole point — so the audit instead proves
        it consistent: every retained byte belongs to a cached
        registered block, the radix links are closed over the registry,
        bytes stay within both budgets, and every host payload is
        either cache-tier (refcount 0, LRU-tracked) or a leak."""
        assert not self.block_tables, \
            f"leaked block tables for slots {sorted(self.block_tables)}"
        assert not self.state_slabs, \
            f"leaked state slabs for slots {sorted(self.state_slabs)}"
        assert not self._ref, f"dangling block refcounts: {self._ref}"
        assert self.pool.in_use == len(self._cached) * self.block_bytes, \
            f"block pool holds {self.pool.in_use} bytes but the cache " \
            f"tier accounts {len(self._cached) * self.block_bytes}"
        assert self.state_pool.in_use == 0, \
            f"state pool still holds {self.state_pool.in_use} bytes"
        assert set(self._registry) == set(self._cached), \
            "prefix registry and cache tier diverged after drain"
        assert sorted(self._slab_hash.values()) == \
            sorted(self._registry), "slab-hash map diverged from registry"
        assert self.in_use <= self.budget, \
            f"cache tier exceeds budget: {self.in_use} > {self.budget}"
        if self.prefix_cache:
            for h in self._registry:
                p = self._parent.get(h)
                assert p == b"kv0" or p in self._registry, \
                    "cached block's parent missing from registry"
            kids = set()
            for s in self._children.values():
                kids |= s
            assert kids == set(self._parent) <= set(self._registry), \
                "radix links not closed over the registry"
        assert not self._published and not self._chain, \
            "publish watermarks outlive their slots"
        assert not self._spilled, \
            f"spilled requests never resolved: {sorted(self._spilled)}"
        pinned = [k for k, e in self._host.items() if e.refs > 0]
        assert not pinned, \
            f"host tier leaks {len(pinned)} pinned blocks"
        assert set(self._host) == set(self._host_lru), \
            "host cache tier and its LRU ring diverged"
        assert self._host_in_use == len(self._host) * self.block_bytes \
            and self._host_in_use <= self.host_budget, \
            f"host tier holds {self._host_in_use} bytes for " \
            f"{len(self._host)} blocks (budget {self.host_budget})"

    def table_ids(self, slot: int) -> "list[int]":
        """The slot's physical block table (slab ids double as pool row
        indices — see class docstring)."""
        return [slab.id for slab in self.block_tables[slot]]

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    @property
    def physical_kv_blocks(self) -> int:
        """Distinct physical KV blocks ever created (peak concurrent) —
        also the minimum pool rows a paged cache needs."""
        return (self.pool.total_allocated // self.block_bytes
                if self.block_bytes else 0)

    def live_block_ids(self) -> "dict[int, set]":
        """slot -> slab-id set (aliasing check for the property tests);
        ids are namespaced per pool since both pools count from 0.
        NOTE: prefix-shared blocks alias across slots BY DESIGN — the
        no-alias invariant only holds for admissions without ``tokens``."""
        out = {s: {("b", b.id) for b in t}
               for s, t in self.block_tables.items()}
        for s, slab in self.state_slabs.items():
            out.setdefault(s, set()).add(("s", slab.id))
        return out
