"""Quickstart of the PyTorch port: the Parallax pipeline end to end on one
model (the twin of ``examples/quickstart.py``).

    python3 examples/torch_quickstart.py                # on the card
    python3 examples/torch_quickstart.py --device cpu   # plain PyTorch

1. Build an architecture DAG (whisper-tiny's encoder, reduced: the
   paper's own model).
2. Run the paper's §3 pipeline: delegate partitioning -> branch/layer
   extraction -> arena planning -> resource-constrained schedule.
3. Execute it and compare against op-by-op framework execution.

The card is the default; without one the script raises unless
``--device cpu`` is given, and its report names the device it ran on.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ParallaxConfig, PlanExecutor,  # noqa: E402
                              compile_plan)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.dag_export import export_graph  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 1. architecture -> DAG ------------------------------------------------
    cfg = get_config("whisper-tiny").reduced()
    api = build_model(cfg, device=args.device)
    device = api.device
    params = api.init(torch.Generator(device=device).manual_seed(0))
    graph, make_inputs = export_graph(cfg, params, batch=1, seq=32)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    print(f"graph: {graph.num_nodes()} nodes, "
          f"{graph.total_flops() / 1e6:.1f} MFLOPs")

    # 2. Parallax compile ---------------------------------------------------
    plan = compile_plan(graph, ParallaxConfig(budget=256 << 20))
    print(f"branches: {len(plan.branches)}  layers: {len(plan.layers)}  "
          f"max parallel width: {plan.schedule.max_width()}")
    print(f"delegates accepted/rejected: "
          f"{len(plan.partition_report.accepted)}/"
          f"{len(plan.partition_report.rejected)}")
    print(f"arena bytes: naive-sum {plan.sum_arena_sizes() / 1024:.0f} KiB "
          f"-> pooled {plan.pooled_arena_peak() / 1024:.0f} KiB "
          f"(cross-arena sharing, paper §3.2)")

    # 3. execute ------------------------------------------------------------
    env = make_inputs(np.random.default_rng(0))
    reference = PlanExecutor(plan, mode="reference", device=device)(env)
    parallax = PlanExecutor(plan, mode="parallax", device=device)(env)
    out_id = graph.outputs[0]
    err = (reference.outputs[out_id]
           - parallax.outputs[out_id]).abs().max().item()
    print(f"parallax output matches framework oracle: max|err| = {err:.2e}")
    print(f"framework {reference.total_seconds() * 1e3:.1f} ms -> "
          f"parallax {parallax.total_seconds() * 1e3:.1f} ms")
    return err


if __name__ == "__main__":
    main()
