"""Optimized delegate partitioning — paper §3.1 + Appendices A/B.

Identifies accelerator-worthy regions in a heterogeneous graph and prunes
delegate candidates that would lose to CPU execution.  A candidate region
``S`` is offloaded only if

    N = |V(S)| >= 3,    F = Σ FLOPs >= F_min,    B / F <= r_max

where ``B`` is the boundary-tensor transfer size.  The thresholds derive
from requiring ``T_offload = L + F/R_acc + B/B_bw < T_cpu = F/R_cpu``
(Appendix B), which simplifies to ``F > L·R_cpu`` and ``B/F < B_bw/R_acc``,
then relaxing for device variability.

Region discovery uses the epoch/convexity construction (the same family of
algorithms as TFLite's ``PartitionGraphIntoIndependentNodeSubsets``, which
the paper modifies): nodes are assigned monotonically non-decreasing epochs
that alternate supported/unsupported kinds along every path, making each
same-epoch connected component *convex* — fusing it can never create a
cycle.

Hardware profiles: the paper's mobile SoC constants are retained as
``MOBILE_SOC``, the default; ``H100`` re-derives the same criterion for
the port's target, an NVIDIA H100 beside its host CPU (the criterion is
a roofline argument and transfers unchanged in form).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import Graph, fuse_region, region_boundary_tensors


@dataclass(frozen=True)
class HardwareProfile:
    """Constants of the offload cost model (paper §3.1 / B.3)."""

    name: str
    dispatch_latency_s: float        # L
    acc_macs_per_s: float            # R_acc
    cpu_macs_per_s: float            # R_cpu
    mem_bw_bytes_per_s: float        # B_bw

    def derived_flops_floor(self) -> float:
        """F > L·R_cpu (compute-bound condition, Appendix B.2)."""
        return self.dispatch_latency_s * self.cpu_macs_per_s

    def derived_bytes_per_mac(self) -> float:
        """B/F < B_bw/R_acc (memory-bound condition, Appendix B.2)."""
        return self.mem_bw_bytes_per_s / self.acc_macs_per_s


# Paper §3.1 representative values: NNAPI burst dispatch 0.2 ms, Snapdragon
# 8 Gen 1 accelerator 2.6e13 MAC/s, LPDDR5 51.2 GB/s, mobile CPU ~1e9 MAC/s.
MOBILE_SOC = HardwareProfile("mobile-soc", 0.2e-3, 2.6e13, 1e9, 51.2e9)

# NVIDIA H100 SXM beside its host CPU.  R_acc and B_bw from NVIDIA's data
# sheet: 67 TFLOP/s of fp32 outside the tensor cores (the DAG exporter's
# node fns compute in fp32) = 33.5e12 MAC/s, and 3.35 TB/s of HBM3.  L and
# R_cpu as `python3 chip_smoke.py`'s "h100 profile" line measured them on
# an NVIDIA H100 80GB HBM3 at a 700.00 W power limit and its host's 8 CPU
# cores: L = 35.77 us, the median host time of one tiny kernel launch plus
# a 4-byte card -> host copy; R_cpu = 2.7523e11 MAC/s, one fp32 1024^3
# matmul on the CPU (3.901 ms).  Both vary from machine to machine.
H100 = HardwareProfile("h100", 35.77e-6, 33.5e12, 2.7523e11, 3.35e12)


@dataclass(frozen=True)
class CostModel:
    """Enforced (relaxed) delegation thresholds, paper §3.1."""

    profile: HardwareProfile = MOBILE_SOC
    min_ops: int = 3                 # N >= 3
    min_flops: float = 1e9           # F >= 1e9 MACs
    max_bytes_per_flop: float = 0.1  # B/F <= 0.1 bytes/MAC

    def accept(self, n_ops: int, flops: float, bytes_boundary: int) -> bool:
        if n_ops < self.min_ops:
            return False
        if flops < self.min_flops:
            return False
        if flops <= 0:
            return False
        return (bytes_boundary / flops) <= self.max_bytes_per_flop


@dataclass
class RegionStats:
    nodes: list
    n_ops: int
    flops: float
    boundary_bytes: int
    accepted: bool


@dataclass
class PartitionReport:
    regions: "list[RegionStats]" = field(default_factory=list)

    @property
    def accepted(self):
        return [r for r in self.regions if r.accepted]

    @property
    def rejected(self):
        return [r for r in self.regions if not r.accepted]


def assign_epochs(graph: Graph) -> "dict[int, int]":
    """Monotone epoch labels; even epochs = delegate-supported kind.

    Along every edge the epoch is non-decreasing and flips parity exactly
    when the supported/unsupported kind flips, so same-epoch node sets are
    convex (see module docstring).
    """
    preds, _ = graph.build_adjacency()
    epoch: dict[int, int] = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        want_parity = 0 if node.supported else 1
        m = max((epoch[p] for p in preds[nid]), default=-1)
        if m < 0:
            epoch[nid] = want_parity
        elif m % 2 == want_parity:
            epoch[nid] = m
        else:
            epoch[nid] = m + 1
    return epoch


def candidate_regions_epoch(graph: Graph) -> "list[set]":
    """Connected components of supported nodes within one epoch.

    This is what *stock* frameworks do (maximal delegation — the paper's
    "Post" graphs): regions may swallow independent parallel branches
    into one opaque delegate, destroying branch-level parallelism."""
    epoch = assign_epochs(graph)
    preds, succs = graph.build_adjacency()
    seen: set = set()
    regions: list[set] = []
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if nid in seen or not node.supported:
            continue
        e = epoch[nid]
        comp = set()
        stack = [nid]
        while stack:
            v = stack.pop()
            if v in comp:
                continue
            comp.add(v)
            seen.add(v)
            for w in list(preds[v]) + list(succs[v]):
                if (w not in comp and graph.nodes[w].supported
                        and epoch[w] == e):
                    stack.append(w)
        regions.append(comp)
    return regions


def candidate_regions(graph: Graph) -> "list[set]":
    """Parallax candidates: maximal supported runs *within one branch*.

    Restricting delegate regions to branch chains (Fig. 1a/1b ordering)
    keeps sibling branches separate — a delegate never swallows the
    parallel structure the later stages exploit ("fine-grained subgraph
    control").  Chain runs are trivially convex, so fusion cannot create
    cycles."""
    from .classify import extract_branches

    regions: list[set] = []
    for br in extract_branches(graph):
        run: list = []
        for nid in br.nodes:
            if graph.nodes[nid].supported:
                run.append(nid)
            else:
                if run:
                    regions.append(set(run))
                run = []
        if run:
            regions.append(set(run))
    return regions


def partition_graph(graph: Graph, cost: "CostModel | None" = None,
                    scope: str = "branch"):
    """§3.1 delegate partitioning: fuse accepted regions, report the rest.

    ``scope="branch"`` (Parallax) keeps regions inside branch chains;
    ``scope="epoch"`` reproduces stock maximal delegation (the Table 7
    "Post" baseline).  Returns ``(new_graph, PartitionReport)``.  Rejected
    candidates are left as individual CPU-fallback nodes ("trims small
    delegated segments to reduce synchronization overhead", Fig. 1a).
    """
    cost = cost or CostModel()
    find = (candidate_regions if scope == "branch"
            else candidate_regions_epoch)
    report = PartitionReport()
    g = graph
    accepted: list[set] = []
    for region in find(graph):
        # N counts *original* ops: fused nodes carry their op count in
        # attrs["N"] (e.g. converter-fused SwiGLU pairs).
        n_ops = sum(graph.nodes[n].attrs.get("N", 1) for n in region)
        flops = sum(graph.nodes[n].flops for n in region)
        in_t, out_t = region_boundary_tensors(graph, region)
        # Boundary transfer excludes resident weights: params live on the
        # accelerator; only activations cross the boundary (§3.1's ∂S is the
        # tensor traffic between S and the rest of the running graph).
        param_ids = set(graph.params)
        b_bytes = sum(graph.tensors[t].nbytes() for t in in_t
                      if t not in param_ids)
        b_bytes += sum(graph.tensors[t].nbytes() for t in out_t)
        ok = cost.accept(n_ops, flops, b_bytes)
        report.regions.append(
            RegionStats(sorted(region), n_ops, flops, b_bytes, ok))
        if ok:
            accepted.append(region)
    for i, region in enumerate(accepted):
        g = fuse_region(g, region, name=f"delegate_{i}")
    return g, report
