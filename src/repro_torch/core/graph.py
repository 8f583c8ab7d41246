"""DAG intermediate representation for Parallax graph analysis (paper §3.1).

The paper operates on a computation graph ``G = (V, E)`` where ``V`` are
operations and ``E`` are tensor dependencies.  This module provides that IR:

* :class:`TensorSpec` — static shape/dtype metadata (with optional symbolic,
  upper-bounded dynamic dimensions, §3.2 "Handling Dynamic Tensor Shapes"),
* :class:`Tensor` / :class:`Node` / :class:`Graph` — the DAG itself,
* :class:`GraphBuilder` — the API model exporters use to emit a graph,
* graph rewrite helpers used by delegate partitioning (region fusion).

Nodes carry an ``op_class`` drawn from the paper's Appendix A taxonomy
(conv / matmul / elementwise / pooling / misc / control_flow) plus the
post-partitioning ``delegate`` class for fused accelerator regions, and an
optional executable ``fn`` so plans can actually run (core/executor.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Op taxonomy (paper Appendix A, Table 8) + structural classes
# --------------------------------------------------------------------------

OP_CLASSES = (
    "conv",          # Conv2D / DepthwiseConv2D
    "matmul",        # FullyConnected / MatMul / einsum contractions
    "elementwise",   # Add, Mul, ReLU, Sub, norm application, ...
    "pooling",       # AvgPool / MaxPool / Mean / Sum reductions
    "misc",          # Reshape / Slice / Transpose / Concat (0-FLOP-ish)
    "control_flow",  # If / While / dynamic ops -> forced Split-Merge (§3.1)
    "delegate",      # fused accelerator region (indivisible unit, §3.1)
)

# Structural labels from Algorithm 1 / Algorithm 3.
SEQUENTIAL = "Sequential"
SPLITTER = "Splitter"
MERGER = "Merger"
SPLIT_MERGE = "Split-Merge"


@dataclass(frozen=True)
class Dim:
    """A symbolic dynamic dimension with a static upper bound.

    The paper's memory estimator does *static shape inference* and sizes
    dynamic tensors by their originating branch's arena (§3.2); we size
    symbolic dims by ``bound`` so peak-memory estimates stay sound.
    """

    name: str
    bound: int

    def __int__(self) -> int:  # pragma: no cover - convenience
        return self.bound


def _dim_size(d: "int | Dim") -> int:
    return d.bound if isinstance(d, Dim) else int(d)


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: str = "float32"

    @property
    def is_dynamic(self) -> bool:
        return any(isinstance(d, Dim) for d in self.shape)

    @property
    def static_shape(self) -> tuple:
        """Upper-bound concrete shape (symbolic dims resolved to bounds)."""
        return tuple(_dim_size(d) for d in self.shape)

    def numel(self) -> int:
        n = 1
        for d in self.static_shape:
            n *= d
        return n

    def itemsize(self) -> int:
        return int(np.dtype(self.dtype).itemsize)

    def nbytes(self) -> int:
        """B-term contribution: numel(T) * sizeof(dtype) (paper §3.1)."""
        return self.numel() * self.itemsize()


@dataclass
class Tensor:
    id: int
    spec: TensorSpec
    name: str = ""
    producer: "int | None" = None  # node id, None for graph inputs / params

    def nbytes(self) -> int:
        return self.spec.nbytes()


@dataclass
class Node:
    id: int
    name: str
    op_class: str
    inputs: tuple          # tensor ids read
    outputs: tuple         # tensor ids produced
    flops: float = 0.0     # Appendix A estimate (MACs*2 counted as FLOPs=MACs
                           # per paper's usage; we store MACs and call it F)
    fn: "Callable | None" = None   # (*arrays) -> tuple(arrays)
    attrs: dict = field(default_factory=dict)
    # True if this op can run inside an accelerator delegate region.  Dynamic
    # / control-flow / unsupported ops are False -> CPU fallback (paper §1).
    supported: bool = True

    def is_control_flow(self) -> bool:
        return self.op_class == "control_flow"


class Graph:
    """A static-single-producer DAG of :class:`Node` over :class:`Tensor`.

    Node-level edges are derived from tensor dependencies: ``u -> v`` iff
    some output tensor of ``u`` is an input of ``v``.
    """

    def __init__(self) -> None:
        self.tensors: dict[int, Tensor] = {}
        self.nodes: dict[int, Node] = {}
        self.inputs: list[int] = []    # graph-input tensor ids
        self.outputs: list[int] = []   # graph-output tensor ids
        self.params: list[int] = []    # weight tensor ids (excluded from
                                       # activation liveness, like the paper's
                                       # static model memory vs arena split)
        self._next_tensor = 0
        self._next_node = 0

    # -- construction ------------------------------------------------------

    def add_tensor(self, spec: TensorSpec, name: str = "",
                   producer: "int | None" = None) -> int:
        tid = self._next_tensor
        self._next_tensor += 1
        self.tensors[tid] = Tensor(tid, spec, name or f"t{tid}", producer)
        return tid

    def add_node(self, name: str, op_class: str, inputs: Sequence[int],
                 out_specs: Sequence[TensorSpec], flops: float = 0.0,
                 fn: "Callable | None" = None, supported: "bool | None" = None,
                 attrs: "dict | None" = None) -> Node:
        if op_class not in OP_CLASSES:
            raise ValueError(f"unknown op_class {op_class!r}")
        nid = self._next_node
        self._next_node += 1
        outs = tuple(self.add_tensor(s, f"{name}:o{i}", producer=nid)
                     for i, s in enumerate(out_specs))
        if supported is None:
            supported = op_class not in ("control_flow",)
        node = Node(nid, name, op_class, tuple(inputs), outs, float(flops),
                    fn, dict(attrs or {}), supported)
        self.nodes[nid] = node
        return node

    # -- topology ----------------------------------------------------------

    def producer_of(self, tid: int) -> "int | None":
        return self.tensors[tid].producer

    def consumers_of(self, tid: int) -> list:
        return [n.id for n in self.nodes.values() if tid in n.inputs]

    def build_adjacency(self):
        """Returns (preds, succs): node id -> sorted list of distinct node ids."""
        consumers: dict[int, list] = {t: [] for t in self.tensors}
        for n in self.nodes.values():
            for t in n.inputs:
                consumers[t].append(n.id)
        preds: dict[int, set] = {n: set() for n in self.nodes}
        succs: dict[int, set] = {n: set() for n in self.nodes}
        for n in self.nodes.values():
            for t in n.outputs:
                for c in consumers[t]:
                    succs[n.id].add(c)
                    preds[c].add(n.id)
        return ({k: sorted(v) for k, v in preds.items()},
                {k: sorted(v) for k, v in succs.items()})

    def topo_order(self) -> list:
        preds, succs = self.build_adjacency()
        indeg = {n: len(p) for n, p in preds.items()}
        # Deterministic Kahn: process lowest ids first.
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: list = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            changed = False
            for s in succs[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
                    changed = True
            if changed:
                ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def validate(self) -> None:
        for n in self.nodes.values():
            for t in list(n.inputs) + list(n.outputs):
                if t not in self.tensors:
                    raise ValueError(f"node {n.name}: unknown tensor {t}")
        for t in self.inputs + self.outputs + self.params:
            if t not in self.tensors:
                raise ValueError(f"unknown boundary tensor {t}")
        self.topo_order()  # raises on cycles

    # -- statistics (paper Table 7) -----------------------------------------

    def num_nodes(self) -> int:
        return len(self.nodes)

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    # -- execution ----------------------------------------------------------

    def execute(self, env: "dict[int, Any]") -> "dict[int, Any]":
        """Reference op-by-op interpreter (topological order).

        ``env`` maps tensor id -> concrete array for all graph inputs and
        params.  Returns the completed environment.  Used as the oracle the
        Parallax executor is validated against.
        """
        env = dict(env)
        for nid in self.topo_order():
            node = self.nodes[nid]
            if node.fn is None:
                raise ValueError(f"node {node.name} has no fn")
            args = [env[t] for t in node.inputs]
            outs = node.fn(*args)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            if len(outs) != len(node.outputs):
                raise ValueError(
                    f"node {node.name}: fn returned {len(outs)} outputs, "
                    f"expected {len(node.outputs)}")
            for t, v in zip(node.outputs, outs):
                env[t] = v
        return env


class GraphBuilder:
    """Convenience layer used by models/dag_export.py."""

    def __init__(self) -> None:
        self.graph = Graph()

    def input(self, shape, dtype="float32", name="input") -> int:
        tid = self.graph.add_tensor(TensorSpec(tuple(shape), dtype), name)
        self.graph.inputs.append(tid)
        return tid

    def param(self, shape, dtype="float32", name="param") -> int:
        tid = self.graph.add_tensor(TensorSpec(tuple(shape), dtype), name)
        self.graph.params.append(tid)
        return tid

    def op(self, name, op_class, inputs, out_specs, flops=0.0, fn=None,
           supported=None, **attrs):
        node = self.graph.add_node(name, op_class, inputs, out_specs, flops,
                                   fn, supported, attrs)
        return node.outputs[0] if len(node.outputs) == 1 else node.outputs

    def mark_output(self, tid: int) -> None:
        self.graph.outputs.append(tid)

    def build(self) -> Graph:
        self.graph.validate()
        return self.graph


# --------------------------------------------------------------------------
# Region fusion (delegate partitioning rewrite, paper §3.1 / Fig. 1a)
# --------------------------------------------------------------------------


def region_boundary_tensors(graph: Graph, region: "set[int]"):
    """Boundary tensors ∂S of a node region S (paper §3.1).

    Returns (in_tensors, out_tensors): tensors crossing into / out of S.
    Params and graph inputs consumed by S count as in-boundary; tensors
    produced in S and consumed outside S (or graph outputs) as out-boundary.
    """
    produced = set()
    for nid in region:
        produced.update(graph.nodes[nid].outputs)
    in_t: list = []
    seen_in = set()
    for nid in sorted(region):
        for t in graph.nodes[nid].inputs:
            if t not in produced and t not in seen_in:
                seen_in.add(t)
                in_t.append(t)
    # consumers map once: O(V+E), not O(V^2)
    consumed_outside: set = set()
    for nid, node in graph.nodes.items():
        if nid in region:
            continue
        consumed_outside.update(node.inputs)
    out_t: list = []
    seen_out = set()
    graph_outputs = set(graph.outputs)
    for nid in sorted(region):
        for t in graph.nodes[nid].outputs:
            if ((t in consumed_outside or t in graph_outputs)
                    and t not in seen_out):
                seen_out.add(t)
                out_t.append(t)
    return in_t, out_t


def fuse_region(graph: Graph, region: "set[int]", name: str) -> Graph:
    """Rewrite ``graph`` with ``region`` collapsed into one delegate node.

    The fused node is *indivisible* for branch extraction (paper: "Delegate
    regions are treated as indivisible units").  Returns a new Graph sharing
    tensor ids with the original (tensors interior to the region survive but
    become unreferenced; boundary tensors keep their ids so downstream
    consumers are untouched).
    """
    in_t, out_t = region_boundary_tensors(graph, region)
    sub_order = [n for n in graph.topo_order() if n in region]
    F = sum(graph.nodes[n].flops for n in region)
    N = len(region)

    old = graph

    def delegate_fn(*args, _order=tuple(sub_order), _in=tuple(in_t),
                    _out=tuple(out_t)):
        env = dict(zip(_in, args))
        for nid in _order:
            node = old.nodes[nid]
            outs = node.fn(*[env[t] for t in node.inputs])
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for t, v in zip(node.outputs, outs):
                env[t] = v
        return tuple(env[t] for t in _out)

    g = Graph()
    g.tensors = dict(graph.tensors)
    g.inputs = list(graph.inputs)
    g.outputs = list(graph.outputs)
    g.params = list(graph.params)
    g._next_tensor = graph._next_tensor
    g._next_node = graph._next_node

    for nid in graph.topo_order():
        if nid in region:
            continue
        g.nodes[nid] = graph.nodes[nid]
    # Delegate node reuses existing out-tensor ids (re-pointing producers).
    did = g._next_node
    g._next_node += 1
    dnode = Node(did, name, "delegate", tuple(in_t), tuple(out_t), F,
                 delegate_fn, {"fused_nodes": sorted(region), "N": N},
                 supported=True)
    g.nodes[did] = dnode
    for t in out_t:
        g.tensors[t] = dataclasses.replace(g.tensors[t], producer=did)
    g.validate()
    return g
