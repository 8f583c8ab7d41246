"""Parallax core: the paper's §3 algorithms as a composable library.

Public API:

    from repro_torch.core import (GraphBuilder, compile_plan, ParallaxConfig,
                                  PlanExecutor)

    g = ...  # build or export a DAG
    plan = compile_plan(g, ParallaxConfig())
    out = PlanExecutor(plan, mode="parallax")(inputs)   # on cuda

Pass ``device="cpu"`` to the executors to run the plain PyTorch path on
the CPU.  ``mode="parallax-hetero"`` places every branch on the host CPU
or the card (``repro_torch.hetero``) and runs one fused callable per
(layer, device) segment (``compile_hetero_schedule``).
"""

from .arena import (ArenaPlan, BumpAllocator, SlabPool, plan_branch_arena,
                    plan_global_arena)
from .balance import DEFAULT_BETA, LayerGroups, balance_ratio, group_layer
from .classify import (Branch, annotate_workloads, branch_dependencies,
                       classify_nodes, extract_branches)
from .compile import (CompiledHeteroSchedule, CompiledLayer, CompiledSchedule,
                      CompiledSegment, CompileStats, HeteroCompileStats,
                      clear_compile_cache, compile_hetero_schedule,
                      compile_schedule, gemm_positions)
from .executor import (ArenaExecutor, LayerTiming, PlanExecutor, RunResult,
                       make_subgraph_fn)
from .flops import (attention_flops, conv2d_flops, elementwise_flops,
                    matmul_flops, misc_flops, pooling_flops, ssd_scan_flops)
from .graph import (Dim, Graph, GraphBuilder, Node, Tensor, TensorSpec,
                    fuse_region, region_boundary_tensors,
                    MERGER, SEQUENTIAL, SPLITTER, SPLIT_MERGE)
from .layers import build_layers, validate_layers
from .liveness import (Lifetime, branch_peak_memory, lifetimes_overlap,
                       peak_memory_bruteforce, peak_memory_linear_scan,
                       tensor_lifetimes)
from .partition import (CostModel, H100, HardwareProfile, MOBILE_SOC,
                        PartitionReport, assign_epochs, candidate_regions,
                        candidate_regions_epoch,
                        partition_graph)
from .pipeline import H100_CONFIG, MOBILE_CONFIG, ParallaxConfig, compile_plan
from .plan import (ExecutionPlan, GraphStats, fn_fingerprint, graph_stats,
                   plan_signature)
from .scheduler import (Schedule, ScheduledLayer, greedy_select,
                        incremental_select, memory_budget,
                        query_available_memory, schedule_layers)

__all__ = [n for n in dir() if not n.startswith("_")]
