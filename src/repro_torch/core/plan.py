"""ExecutionPlan — the artifact produced by the Parallax pipeline.

Bundles every §3 output: partitioned graph, branches with workload
metadata, layers, balanced groups, arena plans, and the resource-
constrained schedule, plus the graph statistics the paper reports in
Table 7 (Nodes / Layers / Par-Layers / Max-Branches).
"""

from __future__ import annotations

import functools
import hashlib
import types
from dataclasses import dataclass, field

from .arena import ArenaPlan
from .balance import LayerGroups
from .classify import Branch
from .graph import Graph
from .partition import PartitionReport
from .scheduler import Schedule


@dataclass
class GraphStats:
    """Table 7 row: structure + parallelism statistics of one graph."""

    nodes: int = 0
    layers: int = 0
    parallel_layers: int = 0     # layers with >= 2 mutually-independent branches
    max_branches: int = 0        # widest layer

    def as_row(self):
        return (self.nodes, self.layers, self.parallel_layers,
                self.max_branches)


@dataclass
class ExecutionPlan:
    graph: Graph
    branches: "dict[int, Branch]"
    layers: "list[list[int]]"                 # branch ids per layer
    layer_groups: "list[LayerGroups]"         # after §3.1 refinement
    arena_plans: "dict[int, ArenaPlan]"       # per-branch arenas (§3.2)
    schedule: Schedule                        # §3.3 greedy schedule
    partition_report: "PartitionReport | None" = None
    stats_pre: "GraphStats | None" = None     # original graph ("Pre")
    stats_post: "GraphStats | None" = None    # after delegation ("Post")
    stats_parallax: "GraphStats | None" = None
    # Heterogeneous device placement (repro.hetero) — None until the plan is
    # heterogenized; folded into plan_signature so placed plans never share
    # compiled artifacts with unplaced ones.
    placement: "object | None" = None         # hetero.placement.PlacementPlan
    attrs: dict = field(default_factory=dict)

    # -- memory accounting (Tables 4/5) ------------------------------------

    def sum_arena_sizes(self) -> int:
        """Branch-isolated footprint with in-branch reuse, no slab sharing."""
        return sum(p.size for p in self.arena_plans.values())

    def pooled_arena_peak(self) -> int:
        """Footprint with §3.2 cross-arena sharing: simulate the schedule
        acquiring/releasing slabs from one SlabPool."""
        from .arena import SlabPool
        pool = SlabPool()
        for sl in self.schedule.layers:
            live = []
            for group in sl.parallel_groups:
                slabs = [pool.acquire(self.arena_plans[b].size)
                         for b in group]
                live.extend(slabs)
            for bid in sl.sequential:
                s = pool.acquire(self.arena_plans[bid].size)
                pool.release(s)    # sequential branch frees immediately
            for s in live:
                pool.release(s)
        return pool.peak_bytes

    def scheduled_parallel_peak(self) -> int:
        """Worst-case concurrent memory the §3.3 schedule admits — must be
        <= budget (asserted by tests)."""
        peak = 0
        for sl in self.schedule.layers:
            for group in sl.parallel_groups:
                peak = max(peak, sum(self.branches[b].peak_memory
                                     for b in group))
        return peak


def _code_digest(code: "types.CodeType", h) -> None:
    h.update(code.co_code)
    h.update(" ".join(code.co_names).encode())   # co_code stores only name
    h.update(" ".join(code.co_varnames).encode())  # *indices*; hash the names
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _code_digest(c, h)
        else:
            h.update(repr(c).encode())


def _value_token(v, depth: int = 0):
    """Fingerprint contribution of a default-arg / closure-cell value.

    Captured callables recurse through :func:`fn_fingerprint` (bounded, so
    self-referential closures of recursive functions terminate); arrays are
    deliberately reduced to (shape, dtype) metadata — hashing weight *values*
    per node would make signatures O(model size).  The compile cache
    compensates by scoping entries per graph object (core/compile.py), so
    two graphs whose fns close over different weights can never share
    compiled callables even though their signatures match.
    """
    if depth > 3:
        return type(v).__qualname__
    if callable(v):
        return fn_fingerprint(v, _depth=depth + 1)
    shape = getattr(v, "shape", None)
    if isinstance(shape, tuple) and hasattr(v, "dtype"):  # array-like only
        return ("array", shape, str(v.dtype))
    if isinstance(v, (tuple, list)):
        return tuple(_value_token(x, depth) for x in v)
    if isinstance(v, (int, float, str, bytes, bool, frozenset, type(None))):
        return repr(v)
    return type(v).__qualname__


def fn_fingerprint(fn, _depth: int = 0):
    """Stable fingerprint of a node's executable ``fn``.

    Hashes bytecode, referenced names, and constants (recursively through
    nested code objects), plus default arguments and closure-cell values
    via :func:`_value_token`, so two structurally identical graph builds
    produce the same fingerprint while different computations (``dot`` vs
    ``tanh(dot)``, ``exp`` vs ``log``) do not.
    """
    if fn is None:
        return None
    if isinstance(fn, functools.partial):
        return ("partial", fn_fingerprint(fn.func, _depth), repr(fn.args),
                repr(sorted(fn.keywords.items())))
    code = getattr(fn, "__code__", None)
    if code is None:  # builtin / callable object
        return ("callable", getattr(type(fn), "__qualname__", str(type(fn))))
    h = hashlib.blake2b(digest_size=16)
    _code_digest(code, h)
    h.update(repr(_value_token(getattr(fn, "__defaults__", None),
                               _depth)).encode())
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            v = cell.cell_contents
        except ValueError:  # empty cell (still being initialized)
            v = "<empty-cell>"
        h.update(repr(_value_token(v, _depth)).encode())
    return (getattr(fn, "__qualname__", ""), h.hexdigest())


def plan_signature(plan: ExecutionPlan):
    """Hashable structural signature of a plan — the compile-cache key.

    Covers the graph (nodes, op classes, tensor wiring, shapes/dtypes, fn
    fingerprints), the branch decomposition, and the §3.3 schedule.  Two
    plans with equal signatures lower to the same fused callables, so the
    schedule compiler (core/compile.py) shares compiled artifacts across
    fresh executors and repeated ``compile_schedule`` calls.
    """
    g = plan.graph
    nodes = tuple(
        (nid, n.name, n.op_class, n.inputs, n.outputs, fn_fingerprint(n.fn))
        for nid, n in sorted(g.nodes.items()))
    tensors = tuple((tid, t.spec.static_shape, t.spec.dtype)
                    for tid, t in sorted(g.tensors.items()))
    branches = tuple((bid, tuple(b.nodes))
                     for bid, b in sorted(plan.branches.items()))
    sched = tuple(
        (sl.layer_index,
         tuple(tuple(grp) for grp in sl.parallel_groups),
         tuple(sl.sequential))
        for sl in plan.schedule.layers)
    io = (tuple(g.inputs), tuple(g.outputs), tuple(g.params))
    placement = (plan.placement.signature()
                 if plan.placement is not None else None)
    return (nodes, tensors, branches, sched, io, placement)


def graph_stats(graph: Graph) -> GraphStats:
    """Compute Table 7 statistics for any graph (Pre/Post/Parallax)."""
    from .classify import annotate_workloads, classify_nodes, extract_branches
    from .layers import build_layers

    labels = classify_nodes(graph)
    branches = extract_branches(graph, labels)
    annotate_workloads(graph, branches)
    layers = build_layers(graph, branches)
    par_layers = sum(1 for l in layers if len(l) >= 2)
    max_br = max((len(l) for l in layers), default=0)
    return GraphStats(graph.num_nodes(), len(layers), par_layers, max_br)
