"""Branch-aware memory management — paper §3.2 (the slab pool only).

The serving slice needs nothing of the arena planner but the cross-arena
slab pool that backs :class:`repro_torch.runtime.kv_cache.BlockKVCache`:
freed blocks return to the pool and back later requests (§3.2
"cross-arena sharing").  The graph and liveness parts arrive with the
planner slice.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

ALIGN = 64  # byte alignment of every allocation


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


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
