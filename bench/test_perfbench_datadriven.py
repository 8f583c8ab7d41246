"""A configuration, a traffic mix (of a kind the benchmark drives, or of
a new kind with its own driver) and a per-layer metric are added by new
files (and manifest entries) alone: the harness finds them by name and
assembles the result line with no edit to a file it already has."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import harness
import run
import tiny

BENCH = Path(__file__).resolve().parent

METRIC = '''"""Documents in the window (a test metric)."""


def read(ctx):
    docs = ctx["run"].get("docs")
    return len(docs) if docs else None
'''

DRIVER = '''"""One document, the same every call, through prefill_fn, closed
loop (a test driver); compared: its last logits, by their error."""

import time

import numpy as np
import torch

from reference import compare


def run(api, params, dm, traffic, seed, seconds, spans, window):
    tokens = np.random.default_rng([seed, 9]).integers(
        0, dm.V, traffic["length"]).astype(np.int32)

    def call():
        with spans("prefill_fn"):
            return api.prefill_fn(params, {"tokens": tokens[None]})[0].cpu()

    call()
    docs = []
    with window() as w:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ta = time.perf_counter()
            out = call()
            docs.append({"length": len(tokens),
                         "ttft_s": time.perf_counter() - ta})
        w["end"] = time.perf_counter()
    return {"kind": "repeat_doc", "window_s": w["end"] - t0,
            "attempted": len(docs), "failed": 0, "docs": docs,
            "check": [{"tokens": tokens, "logits": out}]}


def reference_inputs(record):
    seq = torch.as_tensor(record["check"][0]["tokens"])
    return [seq], [torch.tensor([len(seq) - 1])]


def items(record, ref):
    return [compare.logit_errors(record["check"][0]["logits"], ref[0][0])]


def control_items(record, ref, other):
    return [compare.logit_errors(other[0][0], ref[0][0])]


def summary(record, per_item):
    return {"err_l2": per_item[0][0]}
'''


def _snapshot(root: Path) -> dict:
    return {p: p.read_bytes() for p in (root / "bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_by_files(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _snapshot(root)
    b = root / "bench"
    cfg = dict(tiny.MOE, name="tiny-moe-wide", num_layers=3)
    (b / "configs" / "tiny-moe-wide.json").write_text(json.dumps(
        {"source": "tiny", "reduced": {}, "assumed": {}, "run": cfg}))
    (b / "traffic" / "short-docs.json").write_text(json.dumps(
        dict(tiny.DOCS, length={"lo": 8, "hi": 32, "multiple": 8,
                                "strata": 2})))
    (b / "metrics" / "docs_in_window.py").write_text(METRIC)
    (b / "limits" / "tiny-wide-short.json").write_text(
        json.dumps(tiny.LIMITS["docs"]))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-moe-wide", "source": "tiny",
                                "file": "bench/configs/tiny-moe-wide.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny-wide-short",
                                  "config": "tiny-moe-wide",
                                  "traffic": "short-docs", "chips": 1,
                                  "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "tiny-moe-docs" in m.get("workloads", ()):
            m["workloads"].append("tiny-wide-short")
    manifest["per_layer"].append({
        "name": "docs_in_window", "unit": "docs", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "prefill_tok_s",
        "workloads": ["tiny-wide-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.cell(root, "tiny-wide-short")
    assert cell["config"]["run"]["num_layers"] == 3
    assert cell["traffic"]["length"]["hi"] == 32
    assert "docs_in_window" in [m["name"] for m in cell["per_layer"]]
    result, lines, _ = run.run_cell(root, "tiny-wide-short", 2 ** 31 + 3,
                                    2.5, True, "cpu")
    assert result["correct"], lines
    assert result["metrics"]["docs_in_window"]["value"] >= 1
    assert list(result)[-1] == "checks"
    json.dumps(result)
    result, _, _ = run.run_cell(root, "tiny-wide-short", 5, 2.5, False,
                                "cpu")
    assert {"prefill_tok_s", "doc_ttft_p90_ms", "setup_s"} \
        == set(result["metrics"])
    after = _snapshot(root)
    assert all(after[p] == before[p] for p in before), "a file was edited"
    shutil.rmtree(root / "bench")


def test_new_kind_of_traffic_by_a_driver_file(tmp_path):
    """A mix whose ``driver`` is a new file: found by name, run, judged
    by its own numbers, with no edit to run.py, compare.py or any other
    file the benchmark has."""
    root = tiny.make_root(tmp_path)
    before = _snapshot(root)
    b = root / "bench"
    (b / "drivers" / "repeat_doc.py").write_text(DRIVER)
    (b / "traffic" / "repeat-one.json").write_text(json.dumps(
        {"driver": "repeat_doc", "length": 20}))
    (b / "metrics" / "docs_in_window.py").write_text(METRIC)
    (b / "limits" / "tiny-repeat.json").write_text(
        json.dumps({"err_l2": 1e-4}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny-repeat",
                                  "config": "tiny-moe", "traffic":
                                  "repeat-one", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] in ("prefill_tok_s", "doc_ttft_p90_ms"):
            m["workloads"].append("tiny-repeat")
    manifest["per_layer"].append({
        "name": "docs_in_window", "unit": "docs", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "prefill_tok_s",
        "workloads": ["tiny-repeat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    assert harness.cell(root, "tiny-repeat")["driver"].__name__.endswith(
        "repeat_doc")
    result, lines, _ = run.run_cell(root, "tiny-repeat", 2 ** 31 + 4, 2.5,
                                    True, "cpu")
    assert result["correct"], lines
    assert list(result["checks"]) == ["err_l2"]
    assert result["metrics"]["docs_in_window"]["value"] >= 1
    assert list(result)[-1] == "checks"
    json.dumps(result)
    result, _, _ = run.run_cell(root, "tiny-repeat", 6, 2.5, False, "cpu")
    assert {"prefill_tok_s", "doc_ttft_p90_ms", "setup_s"} \
        == set(result["metrics"])
    after = _snapshot(root)
    assert all(after[p] == before[p] for p in before), "a file was edited"
    shutil.rmtree(root / "bench")
