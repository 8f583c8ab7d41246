"""Schedule compilation — lowering an ExecutionPlan to fused callables.

The interpreted executor walks the §3.3 schedule group-by-group: every
parallel group and every sequential branch is its own callable, so one
run issues O(groups x layers) host dispatches.  On the fine-grained
graphs the paper targets, dispatch overhead then dominates exactly the
branch parallelism Parallax exposes (cf. Opara's schedule-capture
argument in PAPERS.md).

This module makes the *schedule* the unit of dispatch instead:

* **Per-layer fusion** — each :class:`~repro_torch.core.scheduler.
  ScheduledLayer` (all of its parallel groups plus its sequential
  branches) becomes ONE Python closure; calling it is one dispatch, so a
  run issues O(layers) dispatches.  PyTorch runs eagerly, so the closure
  launches the layer's kernels back to back on the current stream with
  no host synchronisation in between.
* **Whole-plan fusion** — opt-in (``whole_plan=True``): the entire
  schedule is one closure (one dispatch per run).
* **Homogeneous-group batching** — a balanced group whose branches share
  chain length and whose chain position p is a *pure* 2-D matmul with
  identical shapes across branches (the β-balance refinement of §3.1 makes
  this the common case: attention heads, expert MLPs) lowers position p to
  one grouped ``branch_matmul`` kernel launch ``(G, M, K) x (G, K, N)``
  instead of G separate products.  Purity is decided by comparing the
  node fn's aten graph (``make_fx`` on meta tensors) with ``torch.mm``'s,
  so epilogue-fused node fns (``tanh(a @ w)``) are never mis-batched.
* **Donated intermediates** — layer inputs produced by an earlier layer
  and dead afterwards are recorded in ``donate_argnums``; with donation
  on, the executor drops them from its working environment after their
  layer so the caching allocator may reuse their blocks.
* **Heterogeneous segments** — for a plan placed by
  ``repro_torch.hetero``, :func:`compile_hetero_schedule` splits every
  scheduled layer into one closure per logical device (host CPU or
  card), and control-flow branches into host-side dynamic regions.
* **Compile cache** — compiled schedules are keyed on
  :func:`~repro_torch.core.plan.plan_signature` within a weak-keyed
  per-graph scope, so repeated runs and fresh executors over an identical
  plan signature reuse the same callables, while two graph objects never
  share artifacts (fn fingerprints reduce closure-captured tensors to
  metadata, so cross-graph sharing could bake one graph's constants into
  another's results).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable

import torch

from ..kernels.branch_matmul.ops import grouped_branch_matmul
from .graph import Graph, Node, region_boundary_tensors
from .plan import ExecutionPlan, fn_fingerprint, plan_signature


# --------------------------------------------------------------------------
# Pure-matmul detection (homogeneous-group batching eligibility)
# --------------------------------------------------------------------------

_PURE_MM_CACHE: dict = {}


def _aten_structure(fn, *args) -> tuple:
    """``fn``'s aten graph on ``args`` with the placeholder names erased:
    per node its op, target and argument positions."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn)(*args)
    index = {n: i for i, n in enumerate(gm.graph.nodes)}
    return tuple(
        (n.op, None if n.op in ("placeholder", "output") else str(n.target),
         repr(torch.fx.node.map_arg(n.args, index.__getitem__)),
         repr(torch.fx.node.map_arg(n.kwargs, index.__getitem__)))
        for n in gm.graph.nodes)


def _is_pure_matmul(graph: Graph, node: Node) -> bool:
    """True iff ``node.fn`` computes exactly ``torch.mm(x, w)`` on 2-D
    inputs.

    Decided by aten-graph equality on the node's static shapes (traced on
    ``meta`` tensors, so nothing runs), cached per (fn fingerprint,
    shapes, dtypes).  ``a @ w``, ``torch.matmul`` and ``torch.mm`` all
    trace to one ``aten.mm``; epilogue-fused matmul nodes (``tanh(a @
    w)``, ``(a @ w) * 0.1``) trace to more and stay off the grouped path.
    """
    if (node.op_class != "matmul" or node.fn is None
            or len(node.inputs) != 2 or len(node.outputs) != 1):
        return False
    x_spec = graph.tensors[node.inputs[0]].spec
    w_spec = graph.tensors[node.inputs[1]].spec
    if len(x_spec.static_shape) != 2 or len(w_spec.static_shape) != 2:
        return False
    if x_spec.is_dynamic or w_spec.is_dynamic:
        return False
    key = (fn_fingerprint(node.fn), x_spec.static_shape, x_spec.dtype,
           w_spec.static_shape, w_spec.dtype)
    if key not in _PURE_MM_CACHE:
        try:
            xa = torch.empty(x_spec.static_shape,
                             dtype=getattr(torch, x_spec.dtype),
                             device="meta")
            wa = torch.empty(w_spec.static_shape,
                             dtype=getattr(torch, w_spec.dtype),
                             device="meta")
            got = _aten_structure(node.fn, xa, wa)
            ref = _aten_structure(lambda a, b: torch.mm(a, b), xa, wa)
            _PURE_MM_CACHE[key] = got == ref
        except Exception:
            _PURE_MM_CACHE[key] = False
    return _PURE_MM_CACHE[key]


def gemm_positions(plan: ExecutionPlan, group: "list[int]") -> "tuple[int, ...]":
    """Chain positions of a balanced group lowered to one grouped GEMM.

    Requires every branch in the group to have the same chain length, and —
    at a given position — every branch's node to be a pure 2-D matmul with
    identical operand shapes/dtypes.  Positions that fail stay per-branch
    (they still fuse into the layer callable; they just don't batch).
    """
    g = plan.graph
    chains = [plan.branches[b].nodes for b in group]
    length = len(chains[0])
    if len(group) < 2 or any(len(c) != length for c in chains):
        return ()
    out = []
    for pos in range(length):
        nodes = [g.nodes[c[pos]] for c in chains]
        if not all(_is_pure_matmul(g, n) for n in nodes):
            continue
        shapes = {(g.tensors[n.inputs[0]].spec.static_shape,
                   g.tensors[n.inputs[1]].spec.static_shape,
                   g.tensors[n.inputs[0]].spec.dtype,
                   g.tensors[n.inputs[1]].spec.dtype) for n in nodes}
        if len(shapes) == 1:
            out.append(pos)
    return tuple(out)


# --------------------------------------------------------------------------
# Lowering
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class CompileStats:
    """Static facts about a lowered schedule (asserted by tests/benchmarks)."""

    layers: int              # fused dispatches per run (per-layer mode)
    units: int               # groups + sequential branches = interpreted dispatches
    batched_groups: int      # balanced groups routed through branch_matmul
    gemm_sites: int          # chain positions lowered to grouped GEMMs


@dataclass
class CompiledLayer:
    layer_index: int
    fn: Callable                   # (*in tensors) -> tuple(out tensors)
    in_ids: "tuple[int, ...]"
    out_ids: "tuple[int, ...]"
    width: int
    donate_argnums: "tuple[int, ...]"   # recorded even when donation is off


@dataclass
class CompiledSchedule:
    layers: "list[CompiledLayer]"
    whole: "CompiledLayer | None"       # set when whole_plan=True
    stats: CompileStats
    use_branch_kernel: bool
    donate: bool

    def dispatches_per_run(self) -> int:
        return 1 if self.whole is not None else len(self.layers)


@dataclass
class CompiledSegment:
    """One fused callable per (scheduled layer, logical device).

    ``dynamic=True`` segments carry no callable: they are control-flow
    regions the heterogeneous runtime executes host-side through
    ``repro_torch.hetero.dynamic`` (per-subgraph capture cache) instead
    of running them inside a fused closure.
    """

    layer_index: int
    device: "tuple[str, int]"           # logical (kind, index)
    fn: "Callable | None"               # None for dynamic segments
    in_ids: "tuple[int, ...]"
    out_ids: "tuple[int, ...]"
    width: int
    branch_ids: "tuple[int, ...]"
    node_ids: "tuple[int, ...]" = ()    # set for dynamic segments
    dynamic: bool = False


@dataclass(frozen=True)
class HeteroCompileStats:
    segments: int             # dispatches per run (incl. dynamic regions)
    dynamic_regions: int
    devices: "tuple[tuple, ...]"        # logical devices with >= 1 segment
    batched_groups: int       # groups intact on one device AND batchable
    gemm_sites: int


@dataclass
class CompiledHeteroSchedule:
    segments: "list[CompiledSegment]"   # layer-major, device-sorted
    stats: HeteroCompileStats
    use_branch_kernel: bool

    def dispatches_per_run(self) -> int:
        return len(self.segments)

    def segments_on(self, device: "tuple[str, int]"):
        return [s for s in self.segments if s.device == device]


def _apply_node(env: dict, node: Node) -> None:
    outs = node.fn(*[env[t] for t in node.inputs])
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    for t, v in zip(node.outputs, outs):
        env[t] = v


def _run_layer(plan: ExecutionPlan, sl, env: dict,
               batch_map: "dict[tuple, frozenset]") -> None:
    """Run one scheduled layer on ``env``."""
    g = plan.graph
    for group in sl.parallel_groups:
        positions = batch_map.get(tuple(group), frozenset())
        if positions:
            chains = [plan.branches[b].nodes for b in group]
            for pos in range(len(chains[0])):
                nodes = [g.nodes[c[pos]] for c in chains]
                if pos in positions:
                    xs = [env[n.inputs[0]] for n in nodes]
                    ws = [env[n.inputs[1]] for n in nodes]
                    for n, o in zip(nodes, grouped_branch_matmul(xs, ws)):
                        env[n.outputs[0]] = o
                else:
                    for n in nodes:
                        _apply_node(env, n)
        else:
            for b in group:
                for nid in plan.branches[b].nodes:
                    _apply_node(env, g.nodes[nid])
    for b in sl.sequential:
        for nid in plan.branches[b].nodes:
            _apply_node(env, g.nodes[nid])


def _batch_map(plan: ExecutionPlan,
               use_branch_kernel: bool) -> "dict[tuple, frozenset]":
    if not use_branch_kernel:
        return {}
    out = {}
    for sl in plan.schedule.layers:
        for group in sl.parallel_groups:
            positions = gemm_positions(plan, group)
            if positions:
                out[tuple(group)] = frozenset(positions)
    return out


def _lower_region(plan: ExecutionPlan, sls: list,
                  batch_map: "dict[tuple, frozenset]"):
    """(fn, in_ids, out_ids) running the given scheduled layers as one
    closure with graph-level boundary inference."""
    region = {nid for sl in sls for b in sl.all_branches()
              for nid in plan.branches[b].nodes}
    in_ids, out_ids = region_boundary_tensors(plan.graph, region)

    def fn(*args):
        env = dict(zip(in_ids, args))
        for sl in sls:
            _run_layer(plan, sl, env, batch_map)
        return tuple(env[t] for t in out_ids)

    return fn, tuple(in_ids), tuple(out_ids)


def _donate_argnums(plan: ExecutionPlan, per_layer_inputs: list):
    """Per layer, arg positions whose tensors die at that layer.

    A layer input is donatable iff it was produced by an earlier layer
    (i.e. it is not a caller-owned graph input / param), it is not a graph
    output, and no later layer reads it.
    """
    last_read: dict[int, int] = {}
    for idx, in_ids in enumerate(per_layer_inputs):
        for t in in_ids:
            last_read[t] = idx
    caller_owned = set(plan.graph.inputs) | set(plan.graph.params)
    outputs = set(plan.graph.outputs)
    donate = []
    for idx, in_ids in enumerate(per_layer_inputs):
        donate.append(tuple(
            i for i, t in enumerate(in_ids)
            if t not in caller_owned and t not in outputs
            and last_read[t] == idx))
    return donate


# --------------------------------------------------------------------------
# Compile cache
# --------------------------------------------------------------------------

# Scoped per graph *object* (weak-keyed): fn fingerprints deliberately reduce
# closure-captured tensors to shape/dtype metadata, so two structurally
# identical graphs closing over different weights share a signature — sharing
# compiled callables across graph objects would bake one graph's weights
# into the other's results.  A graph's compiled schedules close over its
# plan, so :func:`clear_compile_cache` is what frees a graph's weights.
_COMPILE_CACHE: "weakref.WeakKeyDictionary[Graph, dict]" = (
    weakref.WeakKeyDictionary())


def clear_compile_cache() -> None:
    _COMPILE_CACHE.clear()
    _PURE_MM_CACHE.clear()


def compile_schedule(plan: ExecutionPlan, *, whole_plan: bool = False,
                     use_branch_kernel: bool = True,
                     donate: "bool | None" = None) -> CompiledSchedule:
    """Lower ``plan`` into fused callables, reusing cached compilations.

    ``donate=None`` turns donation on exactly when a card is present (the
    counterpart of a default backend that supports it);
    :class:`~repro_torch.core.executor.PlanExecutor` passes it resolved
    from its own device: on for ``cuda``, off for ``cpu``.
    """
    if donate is None:
        donate = torch.cuda.is_available()
    per_graph = _COMPILE_CACHE.setdefault(plan.graph, {})
    key = (plan_signature(plan), whole_plan, use_branch_kernel, donate)
    cached = per_graph.get(key)
    if cached is not None:
        return cached

    batch_map = _batch_map(plan, use_branch_kernel)
    sched = plan.schedule
    units = sum(len(sl.parallel_groups) + len(sl.sequential)
                for sl in sched.layers)
    stats = CompileStats(
        layers=len(sched.layers), units=units,
        batched_groups=len(batch_map),
        gemm_sites=sum(len(p) for p in batch_map.values()))

    layers: list[CompiledLayer] = []
    whole: "CompiledLayer | None" = None
    if whole_plan:
        fn, in_ids, out_ids = _lower_region(plan, list(sched.layers),
                                            batch_map)
        whole = CompiledLayer(-1, fn, in_ids, out_ids, sched.max_width(), ())
    else:
        lowered = [_lower_region(plan, [sl], batch_map)
                   for sl in sched.layers]
        donatable = _donate_argnums(plan, [l[1] for l in lowered])
        for sl, (fn, in_ids, out_ids), nums in zip(sched.layers, lowered,
                                                   donatable):
            layers.append(CompiledLayer(sl.layer_index, fn, in_ids,
                                        out_ids, sl.width(), nums))

    compiled = CompiledSchedule(layers=layers, whole=whole, stats=stats,
                                use_branch_kernel=use_branch_kernel,
                                donate=donate)
    per_graph[key] = compiled
    return compiled


def compile_hetero_schedule(plan: ExecutionPlan, *,
                            use_branch_kernel: bool = True
                            ) -> CompiledHeteroSchedule:
    """Lower a *placed* plan into one fused callable per (layer, device).

    Each scheduled layer is split by the plan's
    :class:`~repro_torch.hetero.placement.PlacementPlan`: branches sharing
    a logical device run in one segment closure; a §3.1-balanced group
    stays a parallel group (grouped-GEMM eligible) only when placement
    kept it intact on a single device — round-robined groups trade kernel
    batching for device-level parallelism.  Dynamic (control-flow)
    branches become fn-less segments executed by ``hetero/dynamic.py``.

    All branches within one scheduled layer are mutually independent (the
    §3.1 layer property), so a layer's segments may run concurrently on
    their devices; the runtime orders them deterministically.  Cached
    like :func:`compile_schedule`; the plan signature already covers the
    placement.
    """
    from .scheduler import ScheduledLayer
    placement = plan.placement
    if placement is None:
        raise ValueError("plan has no placement — heterogenize() it first "
                         "(repro_torch.hetero)")
    per_graph = _COMPILE_CACHE.setdefault(plan.graph, {})
    key = ("hetero", plan_signature(plan), use_branch_kernel)
    cached = per_graph.get(key)
    if cached is not None:
        return cached

    batch_map = _batch_map(plan, use_branch_kernel)
    assign = placement.assignments
    segments: list[CompiledSegment] = []
    intact_batched: set = set()
    for sl in plan.schedule.layers:
        per_dev: dict[tuple, ScheduledLayer] = {}

        def pseudo(dev: tuple) -> ScheduledLayer:
            if dev not in per_dev:
                per_dev[dev] = ScheduledLayer(sl.layer_index)
            return per_dev[dev]

        dynamic_bids: list[int] = []
        for group in sl.parallel_groups:
            static = [b for b in group if not assign[b].dynamic]
            dynamic_bids.extend(b for b in group if assign[b].dynamic)
            devs = {assign[b].key for b in static}
            if static == list(group) and len(devs) == 1:
                pseudo(devs.pop()).parallel_groups.append(list(group))
                if tuple(group) in batch_map:
                    intact_batched.add(tuple(group))
            else:
                for b in static:
                    pseudo(assign[b].key).sequential.append(b)
        for b in sl.sequential:
            if assign[b].dynamic:
                dynamic_bids.append(b)
            else:
                pseudo(assign[b].key).sequential.append(b)

        for dev in sorted(per_dev):
            psl = per_dev[dev]
            fn, in_ids, out_ids = _lower_region(plan, [psl], batch_map)
            segments.append(CompiledSegment(
                sl.layer_index, dev, fn, in_ids, out_ids,
                psl.width(), tuple(psl.all_branches())))
        for b in sorted(dynamic_bids):
            node_ids = tuple(plan.branches[b].nodes)
            in_ids, out_ids = region_boundary_tensors(plan.graph,
                                                      set(node_ids))
            segments.append(CompiledSegment(
                sl.layer_index, assign[b].key, None, tuple(in_ids),
                tuple(out_ids), 1, (b,), node_ids, dynamic=True))

    stats = HeteroCompileStats(
        segments=len(segments),
        dynamic_regions=sum(1 for s in segments if s.dynamic),
        devices=tuple(sorted({s.device for s in segments})),
        batched_groups=len(intact_batched),
        gemm_sites=sum(len(batch_map[g]) for g in intact_batched))
    compiled = CompiledHeteroSchedule(segments=segments, stats=stats,
                                      use_branch_kernel=use_branch_kernel)
    per_graph[key] = compiled
    return compiled
