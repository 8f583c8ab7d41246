"""Node classification and branch identification — paper §3.1, Alg. 1 / 3.

Each node is labeled by connectivity:

* ``Sequential``  (in = 1, out = 1)
* ``Splitter``    (in = 1, out > 1)
* ``Merger``      (in > 1, out = 1)
* ``Split-Merge`` (in > 1, out > 1)

Control-flow operators (If / While / dynamic ops) are *forced* Split-Merge
"to ensure sequential correctness"; delegate regions are indivisible units
(already fused into single nodes by core/partition.py before this runs).

A **branch** is a maximal linear chain of Sequential nodes; Splitter /
Merger / Split-Merge nodes become singleton branches so that every node
belongs to exactly one branch (the partition property our property tests
assert).  Sources (in = 0) and sinks (out = 0) are treated as having the
corresponding degree 1 — a chain can start at a graph input and end at a
graph output.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import (Graph, MERGER, SEQUENTIAL, SPLITTER, SPLIT_MERGE)


def classify_nodes(graph: Graph) -> "dict[int, str]":
    """Label every node per Algorithm 1 lines 1–4 / Algorithm 3 lines 3–14."""
    preds, succs = graph.build_adjacency()
    labels: dict[int, str] = {}
    for nid, node in graph.nodes.items():
        if node.is_control_flow():
            # "control-flow operators (e.g., If, While) are marked
            #  Split-Merge to ensure sequential correctness"
            labels[nid] = SPLIT_MERGE
            continue
        d_in = max(1, len(preds[nid]))    # sources behave like in=1
        d_out = max(1, len(succs[nid]))   # sinks behave like out=1
        if d_in == 1 and d_out == 1:
            labels[nid] = SEQUENTIAL
        elif d_in == 1 and d_out > 1:
            labels[nid] = SPLITTER
        elif d_in > 1 and d_out == 1:
            labels[nid] = MERGER
        else:
            labels[nid] = SPLIT_MERGE
    return labels


@dataclass
class Branch:
    """A maximal linear chain of nodes (paper: "maximal branches")."""

    id: int
    nodes: list                      # node ids, in execution order
    kind: str = SEQUENTIAL           # label of the chain / singleton node

    # Workload metadata (filled by pipeline): paper §3.1 "per-branch
    # workload metadata for later stages".
    n_ops: int = 0                   # N
    flops: float = 0.0               # F
    peak_memory: int = 0             # M_i (paper §3.3), bytes
    delegate: bool = False           # contains a fused delegate node
    attrs: dict = field(default_factory=dict)


def extract_branches(graph: Graph,
                     labels: "dict[int, str] | None" = None
                     ) -> "list[Branch]":
    """Algorithm 1 / Algorithm 3: maximal-chain branch extraction.

    Implementation note: the paper's listing walks forward from any
    unvisited non-Merger/Split-Merge node.  To make chains *maximal*
    irrespective of iteration order we start chains only at chain *heads*:
    a Sequential node whose single predecessor is not Sequential (or which
    has no predecessor).  Non-Sequential nodes become singleton branches.
    Every node lands in exactly one branch.
    """
    if labels is None:
        labels = classify_nodes(graph)
    preds, succs = graph.build_adjacency()
    topo = graph.topo_order()

    visited: set = set()
    branches: list[Branch] = []

    def is_chain_head(nid: int) -> bool:
        if labels[nid] != SEQUENTIAL:
            return False
        ps = preds[nid]
        if not ps:
            return True
        # Sequential => exactly one predecessor.
        return labels[ps[0]] != SEQUENTIAL

    for nid in topo:
        if nid in visited:
            continue
        if is_chain_head(nid):
            chain = []
            v = nid
            while (v is not None and v not in visited
                   and labels[v] == SEQUENTIAL):
                chain.append(v)
                visited.add(v)
                nxt = succs[v]
                v = nxt[0] if len(nxt) == 1 else None
            branches.append(Branch(len(branches), chain, SEQUENTIAL))
    # Remaining nodes (Splitter / Merger / Split-Merge and any Sequential
    # node absorbed above) become singleton branches.
    for nid in topo:
        if nid not in visited:
            visited.add(nid)
            branches.append(Branch(len(branches), [nid], labels[nid]))
    # Renumber in topological order of first node for determinism.
    pos = {n: i for i, n in enumerate(topo)}
    branches.sort(key=lambda b: pos[b.nodes[0]])
    for i, b in enumerate(branches):
        b.id = i
    return branches


def annotate_workloads(graph: Graph, branches: "list[Branch]") -> None:
    """Fill N / F / delegate metadata (paper §3.1 'workload metadata')."""
    for b in branches:
        b.n_ops = sum(
            graph.nodes[n].attrs.get("N", 1) for n in b.nodes)
        b.flops = sum(graph.nodes[n].flops for n in b.nodes)
        b.delegate = any(
            graph.nodes[n].op_class == "delegate" for n in b.nodes)


def branch_dependencies(graph: Graph, branches: "list[Branch]"):
    """Branch-level dependency edges: A -> B iff a node edge crosses A→B."""
    owner: dict[int, int] = {}
    for b in branches:
        for n in b.nodes:
            owner[n] = b.id
    _, succs = graph.build_adjacency()
    deps: dict[int, set] = {b.id: set() for b in branches}   # b -> successors
    rdeps: dict[int, set] = {b.id: set() for b in branches}  # b -> predecessors
    for b in branches:
        for n in b.nodes:
            for s in succs[n]:
                if owner[s] != b.id:
                    deps[b.id].add(owner[s])
                    rdeps[owner[s]].add(b.id)
    return deps, rdeps
