"""Shape inference + liveness analysis + linear-scan peak memory — §3.2/§3.3.

The paper estimates a branch's peak memory ``M_i`` in three steps:

1. *shape inference* — tensor sizes from operator metadata (our TensorSpecs
   are static already; symbolic dims are sized by their upper bound),
2. *liveness analysis* — each tensor's lifetime interval within the branch;
   tensors needed downstream remain active,
3. *linear scan* over interval endpoints maintaining a running total,
   recording the peak.  O(|V|) and fused with branch identification.

Lifetime convention: a tensor is live at step ``i`` iff
``def_idx <= i <= last_use_idx`` — node ``i``'s inputs and outputs are
simultaneously live while it executes.
"""

from __future__ import annotations

from dataclasses import dataclass

from .graph import Graph


@dataclass(frozen=True)
class Lifetime:
    tensor: int
    start: int      # index of the defining node in the execution order
    end: int        # index of the last-using node (inclusive)
    nbytes: int


def tensor_lifetimes(graph: Graph, order: "list[int]",
                     escape_live_to_end: bool = True) -> "list[Lifetime]":
    """Lifetimes of tensors *produced* by nodes in ``order``.

    ``order`` is any execution order (full graph topo order, or one
    branch's node list).  Tensors consumed by nodes outside ``order`` —
    "needed downstream" — or listed as graph outputs stay live to the end
    of the window when ``escape_live_to_end`` (paper §3.3).
    Graph inputs and params are excluded: the arena holds temporary
    activations, not static model memory (paper Table 4's split).
    """
    pos = {nid: i for i, nid in enumerate(order)}
    in_window = set(order)
    graph_outputs = set(graph.outputs)

    consumers: dict[int, list] = {}
    for n in graph.nodes.values():
        for t in n.inputs:
            consumers.setdefault(t, []).append(n.id)

    lifetimes: list[Lifetime] = []
    for nid in order:
        node = graph.nodes[nid]
        for t in node.outputs:
            start = pos[nid]
            end = start
            escapes = t in graph_outputs
            for c in consumers.get(t, ()):  # last use
                if c in in_window:
                    end = max(end, pos[c])
                else:
                    escapes = True
            if escapes and escape_live_to_end:
                end = len(order) - 1
            lifetimes.append(
                Lifetime(t, start, end, graph.tensors[t].nbytes()))
    return lifetimes


def peak_memory_linear_scan(lifetimes: "list[Lifetime]") -> int:
    """Linear sweep over interval endpoints (paper §3.3, O(|V|))."""
    if not lifetimes:
        return 0
    horizon = max(lt.end for lt in lifetimes) + 2
    delta = [0] * horizon
    for lt in lifetimes:
        delta[lt.start] += lt.nbytes
        delta[lt.end + 1] -= lt.nbytes
    peak = 0
    running = 0
    for d in delta:
        running += d
        peak = max(peak, running)
    return peak


def peak_memory_bruteforce(lifetimes: "list[Lifetime]") -> int:
    """O(V^2) oracle used by property tests against the linear scan."""
    if not lifetimes:
        return 0
    peak = 0
    for i in range(max(lt.end for lt in lifetimes) + 1):
        peak = max(peak, sum(lt.nbytes for lt in lifetimes
                             if lt.start <= i <= lt.end))
    return peak


def branch_peak_memory(graph: Graph, branch_nodes: "list[int]") -> int:
    """M_i: estimated peak memory of one branch (paper §3.3)."""
    return peak_memory_linear_scan(tensor_lifetimes(graph, branch_nodes))


def lifetimes_overlap(a: Lifetime, b: Lifetime) -> bool:
    """reuse(Tj, Tk) ⟺ lifetime(Tj) ∩ lifetime(Tk) = ∅  (Eq. 1)."""
    return not (a.end < b.start or b.end < a.start)
