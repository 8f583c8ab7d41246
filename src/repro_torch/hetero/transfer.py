"""Boundary-tensor transfer planning across device placements.

For a placed plan, every tensor edge whose producer and consumer branches
sit on different *logical* devices is a boundary transfer — the ``B`` term
of the paper's offload criterion (§3.1), now accounted per edge instead of
per candidate region.  The planner:

* enumerates :class:`TransferEdge`s from each branch's in-boundary tensors
  (:func:`~repro_torch.core.graph.region_boundary_tensors`, the same ∂S used by
  delegate partitioning) — params are excluded, mirroring partition.py's
  accounting: weights are resident on their consumer's device, only
  activations (and graph inputs) cross at runtime;
* charges each consuming branch its incoming boundary bytes
  (``bytes_in``) — these feed the §3.3 greedy scheduler's ``extra_mems``
  so deferral decisions pay for staged transfer buffers, not just branch
  peak memory (cf. Intra-DP's overlap-aware transfer scheduling in
  PAPERS.md);
* aggregates per layer and in total for the benchmark/report surface.

At runtime ``hetero/executor.py`` issues one ``.to(device)`` copy per
(tensor, destination device) — co-located consumers share the move — so
the executor's observed byte counter equals
``TransferPlan.physical_bytes()`` (asserted by tests and
benchmarks/hetero.py); ``total_bytes`` charges every consumer and is what
feeds the scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.graph import region_boundary_tensors
from ..core.partition import HardwareProfile
from ..core.plan import ExecutionPlan
from .placement import HOST, PlacementPlan

# Logical source of tensors not produced by any branch (graph inputs):
# caller-owned host memory.
EXTERNAL = (HOST, 0)


@dataclass(frozen=True)
class TransferEdge:
    tensor: int
    src: tuple            # (kind, index) — EXTERNAL for graph inputs
    dst: tuple
    nbytes: int
    layer: int            # scheduled layer of the consuming branch
    consumer: int         # consuming branch id


@dataclass
class TransferPlan:
    edges: "list[TransferEdge]" = field(default_factory=list)
    bytes_in: "dict[int, int]" = field(default_factory=dict)  # per branch

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.edges)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def bytes_at_layer(self) -> "dict[int, int]":
        out: dict[int, int] = {}
        for e in self.edges:
            out[e.layer] = out.get(e.layer, 0) + e.nbytes
        return out

    def crossing_keys(self) -> "set[tuple]":
        """(tensor id, dst logical device) pairs the executor must move."""
        return {(e.tensor, e.dst) for e in self.edges}

    def physical_bytes(self) -> int:
        """Bytes actually moved per run: one copy per (tensor, dst) —
        consumers sharing a device share the move.  This is what the
        executor's ``last_transfer_bytes`` counter observes."""
        seen: dict[tuple, int] = {}
        for e in self.edges:
            seen[(e.tensor, e.dst)] = e.nbytes
        return sum(seen.values())

    def seconds(self, profile: HardwareProfile) -> float:
        """Modeled wire time: total boundary bytes over the profile BW."""
        return self.total_bytes / profile.mem_bw_bytes_per_s


def branch_boundary_tensors(plan: ExecutionPlan, branch_id: int):
    """Non-param in-boundary tensors of one branch (∂S restricted to
    activations) — the per-branch byte accounting tests cross-check."""
    graph = plan.graph
    in_t, _ = region_boundary_tensors(
        graph, set(plan.branches[branch_id].nodes))
    params = set(graph.params)
    return [t for t in in_t if t not in params]


def plan_transfers(plan: ExecutionPlan,
                   placement: PlacementPlan) -> TransferPlan:
    """Enumerate every cross-device boundary edge of a placed plan.

    A transfer is recorded per (tensor, consuming branch) whose producer's
    logical device differs from the consumer's — double-counting multiple
    consumers on one device is deliberate for ``bytes_in`` (each deferred
    branch stages its own inputs); ``crossing_keys`` dedupes to the
    physical moves the executor performs.
    """
    graph = plan.graph
    owner = {n: b.id for b in plan.branches.values() for n in b.nodes}
    layer_of: dict[int, int] = {}
    for sl in plan.schedule.layers:
        for bid in sl.all_branches():
            layer_of[bid] = sl.layer_index

    out = TransferPlan()
    for bid in sorted(plan.branches):
        dst = placement.device_of(bid)
        bytes_in = 0
        for t in branch_boundary_tensors(plan, bid):
            producer = graph.producer_of(t)
            src = (placement.device_of(owner[producer])
                   if producer is not None else EXTERNAL)
            if src == dst:
                continue
            nb = graph.tensors[t].nbytes()
            bytes_in += nb
            out.edges.append(TransferEdge(
                t, src, dst, nb, layer_of.get(bid, 0), bid))
        if bytes_in:
            out.bytes_in[bid] = bytes_in
    return out
