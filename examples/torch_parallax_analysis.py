"""Deep-dive of the PyTorch port: the paper's three stages on a
heterogeneous MoE graph (the twin of ``examples/parallax_analysis.py``).

    python3 examples/torch_parallax_analysis.py                # card
    python3 examples/torch_parallax_analysis.py --device cpu   # CPU

Shows, for dbrx-132b (16 experts top-4; reduced widths, FLOP metadata
from the full config):
  (a) §3.1 delegate partitioning with the cost model's accept/reject
      reasoning per region,
  (b) branch/layer structure + β-balance groups,
  (c) §3.2 arena plans (reuse hits, naive vs liveness sizes),
  (d) §3.3 schedule under three different memory budgets.
The plan depends on the graph's shapes and FLOP metadata, not on the
weights; the weights are random, from ``torch.Generator`` seed 0, on the
device the script runs on (the card unless ``--device cpu``).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CostModel, ParallaxConfig,  # noqa: E402
                              compile_plan)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.dag_export import export_graph  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    full = get_config("dbrx-132b")
    cfg = full.reduced()
    api = build_model(cfg, device=args.device)
    params = api.init(torch.Generator(device=api.device).manual_seed(0))
    graph, _ = export_graph(cfg, params, batch=1, seq=64, flops_cfg=full)
    name = (torch.cuda.get_device_name(api.device)
            if api.device.type == "cuda" else "cpu")
    print(f"device: {name}")

    print("== (a) delegate partitioning (§3.1, full-scale FLOP metadata) ==")
    plan = compile_plan(graph, ParallaxConfig(budget=64 << 20))
    cm = CostModel()
    for r in plan.partition_report.regions[:10]:
        why = []
        if r.n_ops < cm.min_ops:
            why.append(f"N={r.n_ops}<3")
        if r.flops < cm.min_flops:
            why.append(f"F={r.flops:.2e}<1e9")
        if r.flops > 0 and r.boundary_bytes / r.flops > cm.max_bytes_per_flop:
            why.append(f"B/F={r.boundary_bytes/r.flops:.3f}>0.1")
        verdict = "ACCEPT" if r.accepted else f"reject ({', '.join(why)})"
        print(f"  region N={r.n_ops:3d} F={r.flops:9.3e} "
              f"B={r.boundary_bytes:8d} -> {verdict}")
    print(f"  ... {len(plan.partition_report.regions)} regions total, "
          f"{len(plan.partition_report.accepted)} accepted")

    print("\n== (b) branch-layer structure ==")
    st = plan.stats_parallax
    print(f"  nodes={st.nodes} layers={st.layers} "
          f"parallel-layers={st.parallel_layers} max-branches="
          f"{st.max_branches}")
    widths = {}
    for sl in plan.schedule.layers:
        for grp in sl.parallel_groups:
            widths[len(grp)] = widths.get(len(grp), 0) + 1
    print(f"  balanced parallel groups by width: {widths}")

    print("\n== (c) arenas (§3.2) ==")
    tot_reuse = sum(p.reuse_hits for p in plan.arena_plans.values())
    print(f"  arenas: {len(plan.arena_plans)}  in-branch reuse hits: "
          f"{tot_reuse}")
    print(f"  sum-of-arenas {plan.sum_arena_sizes()/1024:.0f} KiB -> "
          f"pooled {plan.pooled_arena_peak()/1024:.0f} KiB")

    print("\n== (d) schedule vs memory budget (§3.3) ==")
    for budget in (2 << 20, 16 << 20, 1 << 30):
        p = compile_plan(graph, ParallaxConfig(budget=budget))
        print(f"  budget {budget/2**20:7.1f} MiB -> max width "
              f"{p.schedule.max_width()}, parallel layers "
              f"{p.schedule.num_parallel_layers()}, admitted peak "
              f"{p.scheduled_parallel_peak()/2**20:.2f} MiB")
    print("\ntighter budgets serialize execution instead of risking OOM —")
    print("the paper's resource-constrained scheduling in action.")
    return plan


if __name__ == "__main__":
    main()
