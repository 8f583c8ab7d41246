"""Table 6 analogue of the PyTorch port: layer-wise latency, serialized vs
Parallax-grouped, with branch counts (BR); the twin of
``benchmarks/layerwise.py``.

    python3 benchmarks/torch_layerwise.py                   # on the card
    PYTHONPATH=src python3 benchmarks/torch_layerwise.py --device cpu \\
        --reduced --seq 32

Both executors run *compiled* branches (so the delta isolates branch
grouping, the paper's per-layer claim): the baseline plan caps
``max_parallel=1`` (each branch dispatched alone, in order); the Parallax
plan groups balanced branches per §3.1/§3.3.  ``profile=True`` puts a
barrier after every scheduled layer, so each layer's time is completed
work.  The default is whisper-tiny's encoder (the paper's own layer
table) at full width (d_model 384, 6 heads, 4 layers, 1500 frames, fp32
weights from ``torch.Generator`` seed 0) on the card; without one the
script raises unless ``--device cpu`` is given, and the report names the
device it ran on.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ParallaxConfig, PlanExecutor,  # noqa: E402
                              compile_plan)
from repro_torch.core.executor import to_device  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.dag_export import export_graph  # noqa: E402

ARCH = "whisper-tiny"
CFG_W1 = ParallaxConfig(budget=1 << 30, max_parallel=1)
CFG_PLX = ParallaxConfig(budget=1 << 30, max_parallel=8)


def _layer_times(ex, env, iters):
    for _ in range(3):
        ex(env)
    acc = None
    widths = None
    for _ in range(iters):
        res = ex(env)
        ts = [t.seconds for t in res.layer_timings]
        acc = ts if acc is None else [a + t for a, t in zip(acc, ts)]
        widths = [t.width for t in res.layer_timings]
    return [a / iters for a in acc], widths


def run(batch=1, seq=None, iters=10, device=None, reduced=False):
    """whisper-tiny's encoder DAG; ``seq`` defaults to its 1500 frames."""
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if reduced else cfg
    api = build_model(cfg, device=device, dtype="float32")
    params = api.init(torch.Generator(device=api.device).manual_seed(0))
    g, make = export_graph(cfg, params, batch, seq or cfg.encoder_seq)
    env = to_device(make(np.random.default_rng(0)), api.device)
    base_ex = PlanExecutor(compile_plan(g, CFG_W1), mode="parallax",
                           profile=True, device=api.device)
    plx_ex = PlanExecutor(compile_plan(g, CFG_PLX), mode="parallax",
                          profile=True, device=api.device)

    base_t, _ = _layer_times(base_ex, env, iters)
    plx_t, widths = _layer_times(plx_ex, env, iters)
    assert len(base_t) == len(plx_t)        # same layer structure
    return {ARCH: [{"layer": i, "serialized_ms": s * 1e3,
                    "parallax_ms": p * 1e3, "branches": w}
                   for i, (s, p, w) in enumerate(zip(base_t, plx_t,
                                                     widths))]}


def device_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(device)} ({card})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() widths (CPU smoke runs)")
    ap.add_argument("--seq", type=int, default=None,
                    help="encoder frames (default: the config's, 1500)")
    args = ap.parse_args(argv)
    out = run(seq=args.seq, device=args.device, reduced=args.reduced)
    device = resolve_device(args.device)
    print(f"# Table 6 analogue — layer latency (ms): serialized branches "
          f"vs grouped, and BR counts; device {device_name(device)}")
    for arch, layers in out.items():
        print(f"\n## {arch}")
        print(f"{'layer':>5s} {'serial ms':>10s} {'plx ms':>9s} "
              f"{'BR':>4s} {'delta':>8s}")
        multi = [la for la in layers if la["branches"] > 1]
        single = sorted((la for la in layers if la["branches"] == 1),
                        key=lambda la: -la["serialized_ms"])[:3]
        show = sorted(multi[:6] + single, key=lambda la: la["layer"])
        for la in show:
            d = 100 * (1 - la["parallax_ms"] / max(la["serialized_ms"],
                                                   1e-9))
            print(f"{la['layer']:5d} {la['serialized_ms']:10.3f} "
                  f"{la['parallax_ms']:9.3f} {la['branches']:4d} "
                  f"{d:+7.1f}%")
        tot_s = sum(la["serialized_ms"] for la in layers)
        tot_p = sum(la["parallax_ms"] for la in layers)
        print(f"  all {len(layers)} layers: {tot_s:.3f} -> {tot_p:.3f} ms")
        if multi:
            tot_s = sum(la["serialized_ms"] for la in multi)
            tot_p = sum(la["parallax_ms"] for la in multi)
            print(f"  multi-branch layers total: {tot_s:.2f} -> "
                  f"{tot_p:.2f} ms ({100 * (1 - tot_p / tot_s):+.1f}%)")
    return out


if __name__ == "__main__":
    main()
