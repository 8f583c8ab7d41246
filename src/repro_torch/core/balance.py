"""Workload refinement — paper §3.1 "Further Refinement".

For a layer's branches to execute in parallel, each branch must satisfy

    N > 2    and    F_max / F_min <= beta        (beta = 1.5 in experiments)

i.e. minimal per-branch workload and bounded imbalance (otherwise the
lightest thread idles at the layer barrier — or, in the grouped-GEMM
adaptation, the branch-batched kernel pads too much: padding waste
<= (beta-1)/beta).

``group_layer`` partitions one layer's branches into *balanced parallel
groups* (each of size >= 2, ratio-bounded) plus a sequential remainder.
Delegate branches are exempt from the N > 2 floor: a fused delegate region
already aggregates >= min_ops ops (its node count is carried in attrs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .classify import Branch

DEFAULT_BETA = 1.5
MIN_BRANCH_OPS = 2  # paper: N > 2


@dataclass
class LayerGroups:
    """Execution structure of one layer after refinement."""

    parallel_groups: "list[list[int]]" = field(default_factory=list)
    sequential: "list[int]" = field(default_factory=list)

    def max_width(self) -> int:
        return max((len(g) for g in self.parallel_groups), default=1)


def group_layer(branches: "dict[int, Branch]", layer: "list[int]",
                beta: float = DEFAULT_BETA) -> LayerGroups:
    """Greedy balanced grouping of one layer's branches.

    Branches are sorted by descending F; a group absorbs subsequent branches
    while ``F_max / F_min <= beta``.  Groups that end up singleton, and
    branches failing the N floor, run sequentially.
    """
    out = LayerGroups()
    eligible = []
    for bid in layer:
        b = branches[bid]
        if b.n_ops > MIN_BRANCH_OPS or b.delegate:
            eligible.append(bid)
        else:
            out.sequential.append(bid)
    eligible.sort(key=lambda bid: (-branches[bid].flops, bid))

    i = 0
    while i < len(eligible):
        f_max = max(branches[eligible[i]].flops, 1.0)
        j = i + 1
        while j < len(eligible):
            f_min = max(branches[eligible[j]].flops, 1.0)
            if f_max / f_min > beta:
                break
            j += 1
        group = eligible[i:j]
        if len(group) >= 2:
            out.parallel_groups.append(sorted(group))
        else:
            out.sequential.extend(group)
        i = j
    out.sequential.sort()
    return out


def balance_ratio(branches: "dict[int, Branch]", group: "list[int]") -> float:
    fs = [max(branches[b].flops, 1.0) for b in group]
    return max(fs) / min(fs)
