"""Heterogeneous-execution benchmark of the PyTorch port: placement,
dispatch and transfer counts, the twin of ``benchmarks/hetero.py``.

    python3 benchmarks/torch_hetero.py                # on the card
    PYTHONPATH=src python3 benchmarks/torch_hetero.py --device cpu

For every graph of ``tests/torch_graph_zoo.py`` (plus the wide variants
of ``benchmarks/dispatch.py``), heterogenize the plan with a permissive
profile (zero compute floor: every supported branch is accelerator-worthy,
so the small zoo graphs exercise real splits), run ``parallax-hetero``
and report:

  * per-device dispatch counts (one fused callable per (layer, device)
    segment plus one host dispatch per dynamic control-flow region),
  * planned boundary-transfer bytes (the per-consumer staging charge) and
    the physical bytes the executor moved,
  * dynamic-region count and mean wall time per run.

Every run is checked against the op-by-op oracle on the same device
(rtol = atol = 2e-5: on the card the host segments sum in the CPU's
order), so the benchmark doubles as an end-to-end check that placement
never changes the numerics beyond that.  The card is the default: without
one the script raises unless ``--device cpu`` is given, and the report
names the device it ran on.  On the CPU every logical device aliases it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

import torch_graph_zoo as tz  # noqa: E402
from repro_torch.core import (HardwareProfile, ParallaxConfig,  # noqa: E402
                              PlanExecutor, compile_plan)
from repro_torch.device import resolve_device  # noqa: E402

CFG = ParallaxConfig(budget=1 << 30)
PERMISSIVE = HardwareProfile("permissive", 0.0, 1.0, 1.0, 1.0)


def zoo_cases():
    cases = dict(tz.ALL_ZOO)
    # wide variants: more branches than max_parallel
    cases["diamond-w8"] = lambda: tz.diamond_graph(width=8)
    cases["multihead-h8"] = lambda: tz.multihead_graph(dim=32, heads=8)
    return cases


def _fmt_devices(counts: "dict[tuple, int]") -> str:
    return " ".join(f"{kind[0]}{idx}:{n}"
                    for (kind, idx), n in sorted(counts.items()))


def run(device=None, iters=5, warmup=2):
    device = resolve_device(device)
    rows = []
    for name, builder in sorted(zoo_cases().items()):
        g, make = builder()
        env = make(np.random.default_rng(0))    # host memory, as callers
        plan = compile_plan(g, CFG)
        ref = PlanExecutor(plan, "reference", device=device)(
            env).outputs[g.outputs[0]]
        ex = PlanExecutor(plan, "parallax-hetero", device=device,
                          hetero_profile=PERMISSIVE)
        got = ex(env).outputs[g.outputs[0]]
        torch.testing.assert_close(got.to(device), ref, rtol=2e-5,
                                   atol=2e-5 * max(1.0, float(
                                       ref.abs().max())))
        transfers = ex.plan.attrs["transfers"]
        assert ex.last_transfer_bytes == transfers.physical_bytes()
        assert ex.last_sync_count == 1
        for _ in range(warmup):
            ex(env)
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            ex(env)                             # ends in its one sync
            walls.append(time.perf_counter() - t0)
        rows.append({
            "graph": name,
            "devices": dict(ex.last_device_dispatches),
            "dispatches": ex.last_dispatch_count,
            "dynamic": ex.hetero_stats.dynamic_regions,
            "planned_bytes": transfers.total_bytes,
            "physical_bytes": transfers.physical_bytes(),
            "edges": transfers.num_edges,
            "mean_ms": float(np.mean(walls)) * 1e3,
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# parallax-hetero placement & transfer accounting on {name} "
          f"(host: cpu, {torch.get_num_threads()} threads)")
    print(f"{'graph':14s} {'disp':>5s} {'dyn':>4s} {'planB':>8s} "
          f"{'physB':>8s} {'edges':>6s} {'mean ms':>8s}  per-device")
    rows = run(device)
    for r in rows:
        print(f"{r['graph']:14s} {r['dispatches']:5d} {r['dynamic']:4d} "
              f"{r['planned_bytes']:8d} {r['physical_bytes']:8d} "
              f"{r['edges']:6d} {r['mean_ms']:8.3f}  "
              f"{_fmt_devices(r['devices'])}")
    print(f"\n# totals over the zoo: "
          f"dispatches={sum(r['dispatches'] for r in rows)} "
          f"dynamic-regions={sum(r['dynamic'] for r in rows)} "
          f"physical-transfer-bytes="
          f"{sum(r['physical_bytes'] for r in rows)}")
    assert len(rows) >= 3
    assert any(r["dynamic"] > 0 for r in rows)
    return rows


if __name__ == "__main__":
    main()
