"""Branch-aware memory management — paper §3.2.

Every branch ``b_i`` gets a dedicated memory **arena** ``A_i``; all tensor
allocations of the branch stay inside ``A_i`` (no cross-branch conflicts,
safe parallelism).  Within an arena Parallax uses a *bump-pointer allocator
with liveness analysis*: when a tensor's last use completes its buffer is
reclaimed into a free list for reuse — legal because

    reuse(Tj, Tk)  ⟺  lifetime(Tj) ∩ lifetime(Tk) = ∅        (Eq. 1)

Cross-arena sharing: freed storage of a branch in an earlier,
non-concurrent layer may back a later branch's arena (``SlabPool``).
Dynamic tensors are sized at their upper bound and confined to the
originating branch's arena (§3.2 "Handling Dynamic Tensor Shapes").
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from .graph import Graph
from .liveness import Lifetime, peak_memory_linear_scan, tensor_lifetimes

ALIGN = 64  # byte alignment of every allocation


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


class BumpAllocator:
    """Bump pointer + coalescing best-fit free list (one arena).

    Two mirrored views of the free set are kept in sync: ``free_list``
    sorted by offset (for O(1) neighbor coalescing on free) and
    ``_by_size`` sorted by (size, offset) (for O(log n) best-fit on
    allocate, mirroring ``SlabPool._KEY``).  Ties on size resolve to the
    lowest offset — the same block the previous linear scan chose.
    """

    def __init__(self) -> None:
        self.bump = 0
        self.free_list: list[tuple] = []   # sorted [(offset, size), ...]
        self._by_size: list[tuple] = []    # sorted [(size, offset), ...]
        self.reuse_hits = 0

    def allocate(self, size: int) -> int:
        size = _align(max(size, 1))
        # Best-fit via the size-ordered index (paper: "reclaimed into a
        # free list for reuse by subsequent tensors").
        i = bisect.bisect_left(self._by_size, (size, -1))
        if i < len(self._by_size):
            sz, off = self._by_size.pop(i)
            j = bisect.bisect_left(self.free_list, (off, sz))
            self.free_list.pop(j)
            if sz > size:
                bisect.insort(self.free_list, (off + size, sz - size))
                bisect.insort(self._by_size, (sz - size, off + size))
            self.reuse_hits += 1
            return off
        off = self.bump
        self.bump += size
        return off

    def free(self, offset: int, size: int) -> None:
        """O(log n) insert + O(1) coalescing with the two adjacent blocks
        (the list stays sorted by offset, so neighbors are the only merge
        candidates — no full re-sort per free)."""
        size = _align(max(size, 1))
        lst = self.free_list
        i = bisect.bisect_left(lst, (offset, size))
        start, end = offset, offset + size
        if i > 0 and lst[i - 1][0] + lst[i - 1][1] == start:
            i -= 1
            o, s = lst.pop(i)
            start = o
            self._drop_size(s, o)
        if i < len(lst) and lst[i][0] == end:
            o, s = lst.pop(i)
            end += s
            self._drop_size(s, o)
        lst.insert(i, (start, end - start))
        bisect.insort(self._by_size, (end - start, start))

    def _drop_size(self, size: int, offset: int) -> None:
        j = bisect.bisect_left(self._by_size, (size, offset))
        self._by_size.pop(j)

    @property
    def high_water(self) -> int:
        return self.bump


@dataclass
class ArenaPlan:
    """Buffer plan of one branch arena: tensor id -> (offset, size)."""

    branch_id: int
    offsets: "dict[int, tuple]" = field(default_factory=dict)
    size: int = 0                      # arena high-water (allocated bytes)
    peak_live: int = 0                 # liveness lower bound (Σ live bytes)
    reuse_hits: int = 0

    def overlap_pairs(self, lifetimes: "list[Lifetime]") -> "list[tuple]":
        """Pairs of simultaneously-live tensors whose buffers overlap —
        must be empty for a correct plan (test helper)."""
        by_id = {lt.tensor: lt for lt in lifetimes}
        bad = []
        items = sorted(self.offsets.items())
        for i, (t1, (o1, s1)) in enumerate(items):
            for t2, (o2, s2) in items[i + 1:]:
                l1, l2 = by_id[t1], by_id[t2]
                live_both = not (l1.end < l2.start or l2.end < l1.start)
                mem_overlap = not (o1 + s1 <= o2 or o2 + s2 <= o1)
                if live_both and mem_overlap:
                    bad.append((t1, t2))
        return bad


def plan_branch_arena(graph: Graph, branch_id: int,
                      branch_nodes: "list[int]",
                      naive: bool = False) -> "tuple[ArenaPlan, list]":
    """Compute the arena layout of one branch (§3.2 in-branch reuse).

    Walks the branch in execution order: allocate each node's outputs at
    its step, free buffers whose last use has completed.  ``naive=True``
    disables the free list (every tensor gets separate memory) — the
    paper's "Naive" baseline in Table 5.

    Returns ``(plan, lifetimes)``.
    """
    lifetimes = tensor_lifetimes(graph, branch_nodes)
    by_step_alloc: dict[int, list] = {}
    by_step_free: dict[int, list] = {}
    for lt in lifetimes:
        by_step_alloc.setdefault(lt.start, []).append(lt)
        by_step_free.setdefault(lt.end, []).append(lt)

    alloc = BumpAllocator()
    plan = ArenaPlan(branch_id)
    for step in range(len(branch_nodes)):
        for lt in by_step_alloc.get(step, ()):
            off = alloc.allocate(lt.nbytes)
            plan.offsets[lt.tensor] = (off, _align(max(lt.nbytes, 1)))
        if not naive:
            for lt in by_step_free.get(step, ()):
                off, sz = plan.offsets[lt.tensor]
                alloc.free(off, sz)
    plan.size = alloc.high_water
    plan.peak_live = peak_memory_linear_scan(lifetimes)
    plan.reuse_hits = alloc.reuse_hits
    return plan, lifetimes


def plan_global_arena(graph: Graph, order: "list[int]") -> ArenaPlan:
    """TFLite/ORT-style single global arena with aggressive reuse.

    The paper contrasts this with branch arenas: global reuse minimizes
    memory but "creates data dependencies that block branch-level
    parallelism" (§2).  Used as the SOTA-baseline memory planner in
    benchmarks (Tables 4/5).
    """
    lifetimes = tensor_lifetimes(graph, order)
    by_step_alloc: dict[int, list] = {}
    by_step_free: dict[int, list] = {}
    for lt in lifetimes:
        by_step_alloc.setdefault(lt.start, []).append(lt)
        by_step_free.setdefault(lt.end, []).append(lt)
    alloc = BumpAllocator()
    plan = ArenaPlan(-1)
    for step in range(len(order)):
        for lt in by_step_alloc.get(step, ()):
            off = alloc.allocate(lt.nbytes)
            plan.offsets[lt.tensor] = (off, _align(max(lt.nbytes, 1)))
        for lt in by_step_free.get(step, ()):
            off, sz = plan.offsets[lt.tensor]
            alloc.free(off, sz)
    plan.size = alloc.high_water
    plan.peak_live = peak_memory_linear_scan(lifetimes)
    plan.reuse_hits = alloc.reuse_hits
    return plan


@dataclass
class Slab:
    id: int
    size: int


class SlabPool:
    """Cross-arena buffer sharing (§3.2).

    Branch arenas from non-concurrent layers reuse each other's backing
    storage: when a layer finishes, its slabs return to the pool and later
    layers draw from it.  ``peak_bytes`` is the real footprint of all
    arenas combined; ``sum_of_arena_sizes`` would be the no-sharing cost.
    """

    _KEY = staticmethod(lambda s: (s.size, s.id))

    def __init__(self) -> None:
        self._free: list[Slab] = []     # sorted by (size, id): best fit is
        self._next = 0                  # the first adequate slab
        self.total_allocated = 0
        self.in_use = 0
        self.peak_bytes = 0
        self.reuse_count = 0

    def acquire(self, size: int) -> Slab:
        size = _align(max(size, 1))
        i = bisect.bisect_left(self._free, (size, -1), key=self._KEY)
        if i < len(self._free):
            slab = self._free.pop(i)
            self.reuse_count += 1
        else:
            slab = Slab(self._next, size)
            self._next += 1
            self.total_allocated += size
        self.in_use += slab.size
        self.peak_bytes = max(self.peak_bytes, self.total_allocated)
        return slab

    def release(self, slab: Slab) -> None:
        self.in_use -= slab.size
        bisect.insort(self._free, slab, key=self._KEY)
