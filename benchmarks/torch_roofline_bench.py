"""Roofline table of the PyTorch port: reads the dry-run's
records (``python -m repro_torch.launch.dryrun --all``) into one report.

Per (arch x shape): the three roofline terms, modelled from the H100 data
sheet (``repro_torch.utils.roofline``), the dominant bottleneck, the
MODEL_FLOPS ratio and per-device memory against the card's 80 GB.  No
number here is measured on a card.

    PYTHONPATH=src python benchmarks/torch_roofline_bench.py [pod16x16]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parent / "artifacts" / "dryrun_torch"
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str = "pod16x16"):
    rows = [json.loads(f.read_text())
            for f in sorted(ARTIFACTS.glob(f"*__{mesh}*.json"))]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]),
                             r.get("variant", "")))
    return rows


def main(mesh: str = "pod16x16"):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.utils.roofline import CARD

    rows = load(mesh)
    print(f"# Roofline, {mesh}: terms in seconds a step, modelled from "
          f"the data sheet of an {CARD}")
    print(f"{'arch':18s} {'shape':12s} {'var':8s} {'compute':>9s} "
          f"{'memory':>9s} {'collect':>9s} {'dominant':>10s} "
          f"{'useful':>7s} {'GiB/dev':>8s} {'fits':>5s} {'dispatch':>9s}")
    for r in rows:
        if r["status"] == "skipped":
            print(f"{r['arch']:18s} {r['shape']:12s} SKIP ({r['reason']})")
            continue
        if r["status"] == "error":
            print(f"{r['arch']:18s} {r['shape']:12s} ERROR {r['error']}")
            continue
        rl = r["roofline"]
        fits = "yes" if r["per_device_gb"] * 2**30 <= 80e9 else "no"
        print(f"{r['arch']:18s} {r['shape']:12s} "
              f"{r.get('variant', ''):8s} "
              f"{rl['compute_s']:9.4f} {rl['memory_s']:9.4f} "
              f"{rl['collective_s']:9.4f} {rl['dominant']:>10s} "
              f"{rl['useful_flops_ratio']:7.2f} "
              f"{r['per_device_gb']:8.2f} {fits:>5s} "
              f"{r['lower_s']:8.1f}s")
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "pod16x16")
