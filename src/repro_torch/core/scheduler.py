"""Resource-constrained parallel scheduling — paper §3.3.

At runtime Parallax queries the OS for available free memory, keeps a
30–50 % safety margin, and within each layer greedily selects the largest
subset of branches whose combined estimated peak memory fits the budget:

    Σ_{b_i ∈ chosen} M_i <= M_budget

Unselected branches run sequentially — OOM-free while maximizing safe
concurrency.  A ``max_parallel`` cap models the paper's thread ceiling
(Fig. 3; 6 threads in their experiments — the grouped-GEMM adaptation
uses it as the branch-batch width of the fused kernels).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

DEFAULT_MARGIN = 0.4      # paper: 30-50 % safety margin
DEFAULT_MAX_PARALLEL = 6  # paper §4.3: max thread count 6

MEM_BUDGET_ENV = "PARALLAX_MEM_BUDGET"
_SUFFIXES = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}


def _parse_bytes(text: str) -> int:
    """Byte count from '1073741824', '512M', '8G', ... (case-insensitive)."""
    s = text.strip().upper().removesuffix("B")
    if s and s[-1] in _SUFFIXES:
        return int(float(s[:-1]) * _SUFFIXES[s[-1]])
    return int(s)


def query_available_memory(device=None) -> int:
    """Available memory in bytes for the §3.3 budget on ``device``.

    Resolution order: the ``PARALLAX_MEM_BUDGET`` env var (explicit
    operator override — supports K/M/G/T suffixes, e.g. ``4G``), then,
    for a CUDA ``device``, the card's free memory
    (``torch.cuda.mem_get_info``), else /proc/meminfo MemAvailable, then
    an 8 GiB fallback for platforms exposing neither.  ``device=None``
    (and the CPU) reads the host, as the JAX package does.
    """
    env = os.environ.get(MEM_BUDGET_ENV)
    if env:
        try:
            n = _parse_bytes(env)
        except ValueError as e:
            raise ValueError(
                f"unparseable {MEM_BUDGET_ENV}={env!r}") from e
        if n <= 0:
            raise ValueError(
                f"{MEM_BUDGET_ENV}={env!r} must be positive — a zero or "
                f"negative budget silently serializes every schedule")
        return n
    if device is not None:
        import torch

        device = torch.device(device)
        if device.type == "cuda":
            return int(torch.cuda.mem_get_info(device)[0])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover - non-Linux fallback
        pass
    return 8 << 30


def memory_budget(available: "int | None" = None,
                  margin: float = DEFAULT_MARGIN, device=None) -> int:
    """M_budget = free memory (on ``device`` when ``available`` is not
    given) with a 30–50 % safety margin withheld."""
    if not 0.0 <= margin < 1.0:
        raise ValueError(f"margin must be in [0, 1), got {margin}")
    if available is None:
        available = query_available_memory(device)
    return int(available * (1.0 - margin))


def greedy_select(peak_mems: "dict[int, int]", candidates: "list[int]",
                  budget: int, max_parallel: int = DEFAULT_MAX_PARALLEL,
                  extra_mems: "dict[int, int] | None" = None):
    """Largest-cardinality subset under the memory budget.

    Sorting by ascending M_i and absorbing while the running sum fits
    yields a maximum-cardinality feasible subset (exchange argument: any
    feasible subset can be rebuilt from the smallest items).
    Returns ``(chosen, deferred)`` preserving determinism by (M_i, id).

    ``extra_mems`` charges per-branch surcharges on top of M_i — the
    heterogeneous runtime passes boundary-transfer bytes here
    (hetero/transfer.py), so a branch whose staged cross-device inputs
    would blow the budget is deferred even when its compute peak fits.
    """
    def cost(b: int) -> int:
        return peak_mems[b] + (extra_mems.get(b, 0) if extra_mems else 0)

    order = sorted(candidates, key=lambda b: (cost(b), b))
    chosen: list[int] = []
    total = 0
    for bid in order:
        if len(chosen) >= max_parallel:
            break
        m = cost(bid)
        if total + m <= budget:
            chosen.append(bid)
            total += m
    chosen_set = set(chosen)
    deferred = [b for b in candidates if b not in chosen_set]
    return sorted(chosen), sorted(deferred)


def incremental_select(peak_mems: "dict[int, int]",
                       candidates: "list[int]", budget: int,
                       in_use: int = 0,
                       max_parallel: int = DEFAULT_MAX_PARALLEL,
                       extra_mems: "dict[int, int] | None" = None,
                       reclaimable: int = 0):
    """Iteration-granularity §3.3 admission against *live* headroom.

    The layer scheduler charges every branch its whole-lifetime peak
    upper bound against a fresh budget.  A continuously-batched serving
    engine instead re-runs selection every iteration while earlier
    admissions still hold memory: the effective budget is the pool's
    actual headroom ``budget - in_use``, and each candidate is charged
    only its *next* allocation (e.g. the prompt's cache blocks), not its
    lifetime maximum — later growth is handled lazily by the block pool.

    Returns ``(chosen, deferred)`` exactly like :func:`greedy_select`.

    The effective headroom may be NEGATIVE: a runtime budget shrink
    (fault plane, co-tenant pressure) can push ``in_use`` past
    ``budget`` while earlier admissions still hold memory.  That is a
    valid steady state, not an error — nothing fits until the pool
    drains or the budget is restored, so everything defers.

    ``reclaimable`` credits bytes the caller can free ON DEMAND before
    placement — the serving engine passes the cold KV blocks it could
    spill to its host tier plus the evictable blocks parked in the
    persistent prefix cache, so admission no longer defers everything
    when the device pool is full but those tiers have give.  The
    caller owns actually reclaiming (spilling / evicting) before it
    places what was selected against the credit.
    """
    if in_use < 0:
        raise ValueError(f"in_use must be >= 0, got {in_use}")
    if reclaimable < 0:
        raise ValueError(f"reclaimable must be >= 0, got {reclaimable}")
    headroom = budget - in_use + reclaimable
    if headroom < 0:
        return [], sorted(candidates)
    return greedy_select(peak_mems, candidates, headroom,
                         max_parallel, extra_mems=extra_mems)


@dataclass
class ScheduledLayer:
    layer_index: int
    parallel_groups: "list[list[int]]" = field(default_factory=list)
    sequential: "list[int]" = field(default_factory=list)

    def width(self) -> int:
        return max((len(g) for g in self.parallel_groups), default=1)

    def all_branches(self) -> "list[int]":
        out = [b for g in self.parallel_groups for b in g]
        out.extend(self.sequential)
        return out


@dataclass
class Schedule:
    layers: "list[ScheduledLayer]" = field(default_factory=list)
    budget: int = 0
    max_parallel: int = DEFAULT_MAX_PARALLEL

    def max_width(self) -> int:
        return max((l.width() for l in self.layers), default=1)

    def num_parallel_layers(self) -> int:
        return sum(1 for l in self.layers if l.width() > 1)


def schedule_layers(layer_groups, peak_mems: "dict[int, int]",
                    budget: "int | None" = None,
                    margin: float = DEFAULT_MARGIN,
                    max_parallel: int = DEFAULT_MAX_PARALLEL,
                    extra_mems: "dict[int, int] | None" = None) -> Schedule:
    """Greedy layer scheduling over the refined layer structure.

    ``layer_groups`` is a list of ``balance.LayerGroups`` (one per layer).
    Each balanced group is admitted through :func:`greedy_select`; members
    that do not fit the budget fall back to sequential execution.
    ``extra_mems`` surcharges per-branch costs (e.g. boundary-transfer
    staging bytes from the heterogeneous runtime) against the budget.
    """
    if budget is None:
        budget = memory_budget(margin=margin)
    sched = Schedule(budget=budget, max_parallel=max_parallel)
    for li, groups in enumerate(layer_groups):
        sl = ScheduledLayer(li, sequential=list(groups.sequential))
        for group in groups.parallel_groups:
            chosen, deferred = greedy_select(
                peak_mems, group, budget, max_parallel,
                extra_mems=extra_mems)
            if len(chosen) >= 2:
                sl.parallel_groups.append(chosen)
                sl.sequential.extend(deferred)
            else:
                sl.sequential.extend(group)
        sl.sequential = sorted(set(sl.sequential))
        sched.layers.append(sl)
    return sched
