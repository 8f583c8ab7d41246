"""Tiny cells for the benchmark's CPU tests: a checkout of their own
(``BENCHMARK.json`` and a copy of ``bench/``) whose configurations keep
the served models' structure at widths a CPU runs in a second."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent

MOE = {"name": "tiny-moe", "arch_type": "moe", "num_layers": 2,
       "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
       "d_ff": 0, "vocab_size": 256, "rope_theta": 500000.0,
       "moe": {"num_experts": 8, "num_experts_per_tok": 2,
               "d_ff_expert": 32, "layer_freq": 1, "layer_offset": 0},
       "norm_type": "rmsnorm", "dtype": "float32"}

HYBRID = {"name": "tiny-hybrid", "arch_type": "hybrid", "num_layers": 4,
          "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
          "d_ff": 96, "vocab_size": 256, "attn_period": 4, "attn_offset": 1,
          "moe": {"num_experts": 8, "num_experts_per_tok": 2,
                  "d_ff_expert": 32, "layer_freq": 2, "layer_offset": 1},
          "ssm": {"d_state": 8, "head_dim": 16, "expand": 2, "chunk": 8,
                  "conv_width": 4, "n_groups": 1},
          "norm_type": "rmsnorm", "dtype": "float32"}

DOCS = {"driver": "prefill_closed",
        "length": {"lo": 16, "hi": 64, "multiple": 8, "strata": 2}}

BATCH = {"driver": "batch_decode", "job": 4, "prompt": {"lo": 5, "hi": 9},
         "max_new_tokens": 12,
         "engine": {"max_batch": 4, "max_context": 32, "paged": True,
                    "megastep": 4},
         "check_rows": 6}

CELLS = {"tiny-moe-docs": ("tiny-moe", "docs"),
         "tiny-hybrid-docs": ("tiny-hybrid", "docs"),
         "tiny-moe-batch": ("tiny-moe", "batch")}

LIMITS = {"docs": {"q1_err_l2.short": 0.05, "q1_err_l2.long": 0.05,
                   "q1_err_max.short": 0.3, "q1_err_max.long": 0.3},
          "batch": {"mean_served_gap": 0.1}}


def make_root(tmp: Path, dtype: str = "float32") -> Path:
    """A checkout at ``tmp`` with the tiny cells and a copy of bench/."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns(
        "__pycache__"))
    (root / "src").symlink_to(BENCH.parent / "src")
    b = root / "bench"
    for run in (MOE, HYBRID):
        (b / "configs" / f"{run['name']}.json").write_text(json.dumps(
            {"source": "tiny", "reduced": {}, "assumed": {},
             "run": dict(run, dtype=dtype)}))
    (b / "traffic" / "docs.json").write_text(json.dumps(DOCS))
    (b / "traffic" / "batch.json").write_text(json.dumps(BATCH))
    for name, (_, traffic) in CELLS.items():
        (b / "limits" / f"{name}.json").write_text(
            json.dumps(LIMITS[traffic]))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = [
        {"name": r["name"], "source": "tiny",
         "file": f"bench/configs/{r['name']}.json", "reduced": [],
         "why": "test"} for r in (MOE, HYBRID)]
    manifest["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
        for n, (c, t) in CELLS.items()]
    docs = [n for n, (_, t) in CELLS.items() if t == "docs"]
    batch = [n for n, (_, t) in CELLS.items() if t == "batch"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = docs if ".prefill" in m["name"] or \
                m["name"] in ("prefill_tok_s", "doc_ttft_p90_ms") else batch
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
