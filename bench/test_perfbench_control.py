"""The control comes out not correct: the fp32 reference with its
served-dtype weights rounded to float8 e4m3 (one scale an output
channel), put in the program's place.

On the CPU, at tiny widths in bf16 against the tiny cells' limits; on
the card (``cuda``), each cell of ``BENCHMARK.json`` at its own widths
and load with a short window: the program within every limit, the
control over one at least."""

from __future__ import annotations

import json

import pytest

import harness
import run
import tiny
from reference import compare


@pytest.fixture(scope="module")
def bf16_root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bf16"), dtype="bfloat16")


@pytest.mark.parametrize("cell", ["tiny-moe-docs", "tiny-hybrid-docs"])
def test_control_fails_tiny_bf16(bf16_root, cell):
    c = harness.cell(bf16_root, cell)
    result, lines, record = run.run_cell(bf16_root, cell, 2 ** 31 + 21,
                                         2.5, False, "cpu")
    limits = {k: v["limit"] for k, v in result["checks"].items()}
    ctl = compare.control_numbers(c["config"]["run"], 2 ** 31 + 21, record,
                                  c["driver"], "cpu")
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)
    prog = {k: v["value"] for k, v in result["checks"].items()}
    assert all(ctl[k] > prog[k] for k in limits), (ctl, prog)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [
    ("jamba-longdoc-prefill", 8.0), ("dbrx-longdoc-prefill", 8.0),
    ("dbrx-batch-decode", 10.0)])
def test_control_fails_on_card(card, cell, seconds):
    root = harness.checkout_root()
    harness.setup_environment(root)
    c = harness.cell(root, cell)
    result, lines, record = run.run_cell(root, cell, 2 ** 31 + 77, seconds,
                                         False, card)
    limits = {k: v["limit"] for k, v in result["checks"].items()}
    ctl = compare.control_numbers(c["config"]["run"], 2 ** 31 + 77, record,
                                  c["driver"], card)
    print(json.dumps({"program": result["checks"], "control": ctl}))
    assert result["correct"], lines
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)
