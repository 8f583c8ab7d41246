"""``examples/torch_quickstart.py`` on the CPU, in a child process.

The example builds whisper-tiny's reduced encoder DAG, plans it and runs
``reference`` against fused ``parallax``.  Its printed plan (branches,
layers, parallel width, delegates, arena bytes) must equal the JAX
planner's on the JAX exporter's graph of the same config, and its two
executions agree within the repository's fp32 tolerance, 2e-5.
"""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_quickstart_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "device: cpu" in out
    err = float(re.search(r"max\|err\| = (\S+)", out).group(1))
    assert err <= 2e-5

    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.core import ParallaxConfig, compile_plan
    from repro.models import build_model
    from repro.models.dag_export import export_graph

    cfg = get_config("whisper-tiny").reduced()
    params = build_model(cfg).init(jax.random.key(0))
    graph, _ = export_graph(cfg, params, batch=1, seq=32)
    plan = compile_plan(graph, ParallaxConfig(budget=256 << 20))
    assert (f"graph: {graph.num_nodes()} nodes, "
            f"{graph.total_flops() / 1e6:.1f} MFLOPs") in out
    assert (f"branches: {len(plan.branches)}  layers: {len(plan.layers)}  "
            f"max parallel width: {plan.schedule.max_width()}") in out
    assert (f"delegates accepted/rejected: "
            f"{len(plan.partition_report.accepted)}/"
            f"{len(plan.partition_report.rejected)}") in out
    assert (f"naive-sum {plan.sum_arena_sizes() / 1024:.0f} KiB -> pooled "
            f"{plan.pooled_arena_peak() / 1024:.0f} KiB") in out
