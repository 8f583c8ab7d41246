"""The readers of the program's model-step spans on tiny cells (CPU):
``host_syncs_per_dispatch.decode`` counts each MoE layer's capacity read
in every fused step over ``CAPACITY_STEP`` rows plus the megastep's 8
input copies and the engine's 3 result copies, in the window's
megasteps alone; ``moe_idle.decode`` and ``attention_idle.decode`` read
a number or nothing and never raise; and the tiny cells the benchmark
had read what they read before."""

from __future__ import annotations

import json

import pytest

import harness
import run
import tiny

NEW = ("host_syncs_per_dispatch.decode", "moe_idle.decode",
       "attention_idle.decode")
#: what the tiny cells read on the CPU before these metrics
BEFORE = {"batch": {"device_idle.decode", "dispatches_per_token.decode",
                    "kv_pool_peak_share.decode", "mfu.decode"},
          "docs": {"device_idle.prefill", "mfu.prefill"}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout plus ``tiny-moe-batch40``: 40 rows, megastep 4,
    13 new tokens (the first from the prompt's last step, then three
    megasteps of 4, so every megastep has N = 4)."""
    root = tiny.make_root(tmp_path_factory.mktemp("tracing"))
    b = root / "bench"
    traffic = dict(tiny.BATCH, job=40, max_new_tokens=13,
                   engine=dict(tiny.BATCH["engine"], max_batch=40))
    (b / "traffic" / "batch40.json").write_text(json.dumps(traffic))
    (b / "limits" / "tiny-moe-batch40.json").write_text(
        json.dumps(tiny.LIMITS["batch"]))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny-moe-batch40",
                                  "config": "tiny-moe", "traffic": "batch40",
                                  "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "tiny-moe-batch" in m.get("workloads", ()):
            m["workloads"].append("tiny-moe-batch40")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture(scope="module")
def batch40(root):
    """One traced run of ``tiny-moe-batch40``: (result, lines, record)."""
    return run.run_cell(root, "tiny-moe-batch40", 2 ** 31 + 40, 2.5, True,
                        "cpu")


def test_syncs_per_megastep_at_40_rows(batch40):
    assert tiny.BATCH["engine"]["megastep"] == 4
    result, lines, record = batch40
    assert result["correct"], lines
    metrics = result["metrics"]
    # 2 MoE layers x 4 fused steps + 8 input and 3 result copies, every
    # megastep N=4
    assert metrics["host_syncs_per_dispatch.decode"]["value"] == 19
    assert metrics["host_syncs_per_dispatch.decode"]["unit"] \
        == "sync/dispatch"
    for name in NEW[1:]:
        assert name not in metrics or metrics[name]["value"] >= 0
    names = {n for n, _, _ in record["spans"]}
    assert {"megastep", "embed", "attn", "moe.route", "moe.dispatch",
            "moe.experts", "moe.combine", "head",
            "sync.moe_capacity", "sync.engine_copy",
            "sync.step_inputs"} <= names


def test_syncs_per_megastep_leave_out_set_up(root, batch40):
    """Megasteps before the window (set-up's) do not count: the 40-row
    record with three set-up megasteps of one copy each put before its
    window still reads 19, where the whole record would read less."""
    _, _, record = batch40
    reader = harness.load_metric(root, NEW[0])
    spans = record["spans"]
    first = min(s for _, s, _ in spans)
    set_up = []
    for k in range(3):
        at = first - (k + 1) * 10 ** 7
        set_up += [("megastep", at, at + 10 ** 6),
                   ("sync.engine_copy", at + 10, at + 20)]
    moved = dict(record, spans=set_up + spans)
    assert reader.read({"run": moved, "trace": None}) == 19
    whole = dict(moved, window_s=1e9)
    assert reader.read({"run": whole, "trace": None}) < 19


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cells_read_as_before(root, cell):
    result, lines, _ = run.run_cell(root, cell, 2 ** 31 + 41, 2.5, True,
                                    "cpu")
    assert result["correct"], lines
    applies = {m["name"] for m in harness.cell(root, cell)["per_layer"]}
    got = set(result["metrics"])
    traffic = tiny.CELLS[cell][1]
    assert got - set(NEW) == BEFORE[traffic]
    if traffic == "batch":
        assert set(NEW) <= applies
        # 4 rows: no capacity read, the copies in and out alone
        assert result["metrics"][NEW[0]]["value"] == 11
    else:
        assert not applies & set(NEW) and not got & set(NEW)


@pytest.mark.parametrize("name", NEW)
def test_readers_without_program_spans(name):
    """The parent program records no model span: nothing is read."""
    reader = harness.load_metric(harness.checkout_root(), name)
    trace = {"busy_s": 1.0, "window_s": 2.0, "by_name": {},
             "idle": {"megastep: 3 gaps": (3, 1.0), "megastep": (3, 1.0)}}
    run_rec = {"spans": [("megastep", 0, 10), ("iteration", 0, 12)]}
    assert reader.read({"run": run_rec, "trace": trace}) is None
    assert reader.read({"run": {}, "trace": None}) is None
