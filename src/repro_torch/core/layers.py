"""Layer construction via topological sort — paper §3.1, Alg. 2 / 4.

Branches are grouped into *layers*: all branches in a layer have had every
dependency satisfied by earlier layers, so branches within one layer are
mutually independent and may execute in parallel (subject to the §3.1
refinement and the §3.3 memory-budget schedule).
"""

from __future__ import annotations

from .classify import Branch, branch_dependencies
from .graph import Graph


def build_layers(graph: Graph, branches: "list[Branch]") -> "list[list[int]]":
    """Kahn-style level construction (Algorithm 2 / Algorithm 4).

    Returns a list of layers; each layer is a sorted list of branch ids.
    """
    deps, rdeps = branch_dependencies(graph, branches)
    d = {b.id: len(rdeps[b.id]) for b in branches}          # in-degree map
    queue = sorted(bid for bid, deg in d.items() if deg == 0)
    layers: list[list[int]] = []
    emitted = 0
    while queue:
        layer = list(queue)                                  # layer <- Q
        queue = []
        for bid in layer:                                    # process branch b
            for dep in sorted(deps[bid]):                    # b' dependent on b
                d[dep] -= 1
                if d[dep] == 0:
                    queue.append(dep)
        queue.sort()
        layers.append(sorted(layer))
        emitted += len(layer)
    if emitted != len(branches):
        raise ValueError("branch dependency graph has a cycle")
    return layers


def validate_layers(graph: Graph, branches: "list[Branch]",
                    layers: "list[list[int]]") -> None:
    """Asserts the defining layer property: no intra-layer dependencies and
    every dependency points to a strictly earlier layer."""
    deps, _ = branch_dependencies(graph, branches)
    level = {}
    for li, layer in enumerate(layers):
        for bid in layer:
            level[bid] = li
    for bid, succs in deps.items():
        for s in succs:
            if level[s] <= level[bid]:
                raise AssertionError(
                    f"branch {s} (layer {level[s]}) depends on branch {bid} "
                    f"(layer {level[bid]}) but is not in a later layer")
