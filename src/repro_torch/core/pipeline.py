"""The Parallax "compiler" pipeline: Graph -> ExecutionPlan.

Chains the three coordinated stages of the paper (Fig. 1):

  (a) delegate partitioning (cost-model pruning of accelerator regions),
  (b) branch / layer structure identification + workload refinement,
  (c) branch-aware arena planning + resource-constrained scheduling.

``ParallaxConfig`` exposes every knob the paper ablates (thresholds, beta,
memory margin, max parallel width) plus switches used by the benchmark
ablations (disable partitioning / disable balancing).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .arena import plan_branch_arena
from .balance import DEFAULT_BETA, LayerGroups, group_layer
from .classify import annotate_workloads, classify_nodes, extract_branches
from .graph import Graph
from .layers import build_layers, validate_layers
from .liveness import branch_peak_memory
from .partition import H100, CostModel, MOBILE_SOC, partition_graph
from .plan import ExecutionPlan, graph_stats
from .scheduler import (DEFAULT_MARGIN, DEFAULT_MAX_PARALLEL, memory_budget,
                        schedule_layers)


@dataclass(frozen=True)
class ParallaxConfig:
    cost_model: CostModel = CostModel()
    beta: float = DEFAULT_BETA
    margin: float = DEFAULT_MARGIN
    max_parallel: int = DEFAULT_MAX_PARALLEL
    budget: "int | None" = None          # None -> free memory on device
    device: "str | None" = None          # where the plan runs; None: host
    enable_partitioning: bool = True     # ablation switches
    enable_balancing: bool = True
    naive_arenas: bool = False           # Table 5 "Naive" baseline

    def with_(self, **kw) -> "ParallaxConfig":
        return replace(self, **kw)


MOBILE_CONFIG = ParallaxConfig(cost_model=CostModel(profile=MOBILE_SOC))
H100_CONFIG = ParallaxConfig(cost_model=CostModel(profile=H100))


def compile_plan(graph: Graph,
                 config: "ParallaxConfig | None" = None) -> ExecutionPlan:
    config = config or ParallaxConfig()
    stats_pre = graph_stats(graph)

    # "Post" baseline (paper Table 7): naive delegation fusing *every*
    # supported region regardless of cost — what stock frameworks do before
    # Parallax trims small delegate segments.
    naive_cost = CostModel(profile=config.cost_model.profile, min_ops=1,
                           min_flops=0.0, max_bytes_per_flop=float("inf"))
    g_naive, _ = partition_graph(graph, naive_cost, scope="epoch")
    stats_post = graph_stats(g_naive)

    # (a) §3.1 optimized delegate partitioning
    if config.enable_partitioning:
        g, report = partition_graph(graph, config.cost_model)
    else:
        g, report = graph, None

    # (b) §3.1 branch-layer structure + refinement
    labels = classify_nodes(g)
    branch_list = extract_branches(g, labels)
    annotate_workloads(g, branch_list)
    branches = {b.id: b for b in branch_list}
    layers = build_layers(g, branch_list)
    validate_layers(g, branch_list, layers)

    if config.enable_balancing:
        layer_groups = [group_layer(branches, l, config.beta) for l in layers]
    else:
        # Every multi-branch layer is one unchecked parallel group.
        layer_groups = [
            LayerGroups(parallel_groups=[list(l)] if len(l) >= 2 else [],
                        sequential=list(l) if len(l) < 2 else [])
            for l in layers]

    # (c) §3.2 arenas + §3.3 peak memory & greedy schedule
    arena_plans = {}
    for b in branch_list:
        plan, _ = plan_branch_arena(g, b.id, b.nodes,
                                    naive=config.naive_arenas)
        arena_plans[b.id] = plan
        b.peak_memory = branch_peak_memory(g, b.nodes)

    peak_mems = {b.id: b.peak_memory for b in branch_list}
    budget = (config.budget if config.budget is not None
              else memory_budget(margin=config.margin,
                                 device=config.device))
    schedule = schedule_layers(layer_groups, peak_mems, budget=budget,
                               margin=config.margin,
                               max_parallel=config.max_parallel)

    plan = ExecutionPlan(
        graph=g, branches=branches, layers=layers, layer_groups=layer_groups,
        arena_plans=arena_plans, schedule=schedule,
        partition_report=report, stats_pre=stats_pre, stats_post=stats_post,
        stats_parallax=graph_stats(g))
    plan.attrs["config"] = config
    return plan
