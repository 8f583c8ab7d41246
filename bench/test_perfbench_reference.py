"""The benchmark's fp32 reference against the port at tiny widths (CPU),
and its operation and byte counts against hand counts at the served
models' shapes."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import driving
import flops
import harness
import stack
import tiny
from reference import compare, model

BENCH = Path(__file__).resolve().parent
PREFILL = harness.load_driver(BENCH.parent, "prefill_closed")
BATCH = harness.load_driver(BENCH.parent, "batch_decode")


@pytest.mark.parametrize("run_cfg", [tiny.MOE, tiny.HYBRID],
                         ids=["moe", "hybrid"])
def test_reference_matches_port_prefill(run_cfg):
    """fp32 both sides: the last position's logits of ``prefill_fn``
    equal the reference's to rounding, with the same seeded weights."""
    api, params = driving.build(run_cfg, 1234, torch.device("cpu"))
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, run_cfg["vocab_size"], n).astype(np.int32)
            for n in (16, 40)]
    with torch.no_grad():
        prog = [api.prefill_fn(params, {"tokens": s[None]})[0] for s in seqs]
    ref = model.logits(run_cfg, 1234, [torch.as_tensor(s) for s in seqs],
                       [torch.tensor([len(s) - 1]) for s in seqs], "cpu")
    for p, r in zip(prog, ref):
        l2, mx = compare.logit_errors(p, r[0])
        assert l2 < 1e-5 and mx < 1e-4, (l2, mx)


def test_reference_follows_served_tokens():
    """Greedy tokens served by the engine are the reference's best at
    every position (fp32 both sides; a near tie may differ by rounding
    only)."""
    api, params = driving.build(tiny.MOE, 77, torch.device("cpu"))
    record = BATCH.run(api, params, stack.Dims(tiny.MOE), tiny.BATCH, 77,
                       0.2, driving.Spans(False), _null_window)
    assert record["tokens"] > 0 and record["failed"] == 0
    # every token a row processed in the window, at its cache position
    assert len(record["positions"]) >= record["tokens"]
    n = compare.numbers(tiny.MOE, 77, record, BATCH, "cpu")
    assert n["mean_served_gap"] < 1e-4


def test_weights_redraw_bit_for_bit():
    dm = stack.Dims(tiny.HYBRID)
    a = stack.layer_of(dm, 2 ** 31 + 5, 0, "cpu")
    b = stack.layer_of(dm, 2 ** 31 + 5, 0, "cpu")
    c = stack.layer_of(dm, 2 ** 31 + 6, 0, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mamba.in_proj"], c["mamba.in_proj"])


def test_fp8_control_rounds_served_weights_only():
    w = torch.randn(64, 32)
    q = model.fp8(w, -2)
    rel = ((q - w).norm() / w.norm()).item()
    assert 0.005 < rel < 0.1
    wts = model.Weights({"a": w.clone(), "router": w.clone()},
                        [stack.Leaf("a", (64, 32), False, "fan_in"),
                         stack.Leaf("router", (64, 32), True, "fan_in")],
                        "fp8")
    assert torch.equal(wts("router"), w)
    assert not torch.equal(wts("a"), w)


def _config(name):
    return stack.Dims(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text())["run"])


def test_flops_dbrx_by_hand():
    dm = _config("dbrx-132b-8l")
    d, H, K, D, E, k, f, V = 6144, 48, 8, 128, 16, 4, 10752, 100352
    per_layer = (2 * d * (H + 2 * K) * D + 2 * H * D * d
                 + 2 * d * E + k * 3 * 2 * d * f)
    assert flops.token_flops(dm) == 8 * per_layer
    # 2 * active parameters a token: 8 layers of 4 of 16 experts, attention
    assert flops.token_flops(dm) / 2 == 8 * (3 * k * d * f + 2 * d * d
                                             + 2 * d * K * D + d * E)
    S = 4096
    attn = 8 * 4 * H * D * S * (S + 1) / 2
    assert flops.prefill_flops(dm, S) == S * 8 * per_layer + attn + 2 * d * V
    assert flops.decode_flops(dm, 99) == 8 * per_layer \
        + 8 * 4 * H * D * 100 + 2 * d * V
    # expert GEMMs at prefill: compute-bound, the routed rows' operations
    rows = S * k
    assert flops.grouped_gemm_s(dm, rows) == pytest.approx(
        3 * 2 * rows * d * f / 989.4e12)
    # at decode (128 rows): every expert's weights read once bound it
    rows = 128 * k
    bytes_ = 2 * (2 * (rows * d + E * d * f + rows * f)
                  + (rows * f + E * f * d + rows * d))
    assert flops.grouped_gemm_s(dm, rows) == pytest.approx(bytes_ / 3.35e12)
    # paged decode: K and V of every valid position, q and out once
    lens = [99, 199]
    b = 2 * (2 * K * D * 300 + 2 * H * D * 2)
    assert flops.paged_decode_s(dm, lens) == pytest.approx(b / 3.35e12)


def test_flops_jamba_by_hand():
    dm = _config("jamba-v0.1-52b-16l")
    plan = dm.plan()
    assert [m for m, _ in plan].count("attn") == 2
    assert [i for i, (m, _) in enumerate(plan) if m == "attn"] == [4, 12]
    assert [i for i, (_, c) in enumerate(plan) if c == "moe"] \
        == list(range(1, 16, 2))
    d, di, Hm, P, N, Kw = 4096, 8192, 128, 64, 16, 4
    conv_dim = di + 2 * N
    mamba = (2 * d * (2 * di + 2 * N + Hm) + 2 * Kw * conv_dim
             + 4 * Hm * P * N + 2 * di * d)
    attn = 2 * d * (32 + 16) * 128 + 2 * 32 * 128 * d
    moe = 2 * d * 16 + 2 * 3 * 2 * d * 14336
    dense = 3 * 2 * d * 14336
    assert flops.token_flops(dm) == 14 * mamba + 2 * attn + 8 * moe \
        + 8 * dense
    S = 2048
    ops = 4 * S * Hm * P * N
    nbytes = 4 * (2 * S * Hm * P + S * Hm + 2 * S * N + Hm)
    assert flops.ssd_scan_s(dm, S) == pytest.approx(
        max(ops / 67e12, nbytes / 3.35e12))
    assert flops.ssd_scan_s(dm, S) == pytest.approx(nbytes / 3.35e12)
    fl = 4 * 32 * 128 * S * (S + 1) / 2
    assert flops.flash_s(dm, S) == pytest.approx(fl / 989.4e12)


def test_doc_lengths_every_seed_the_same_set():
    t = json.loads((BENCH / "traffic" / "longdoc-2k-8k.json").read_text())
    lengths = PREFILL.doc_lengths(t)
    assert len(lengths) == 16 and min(lengths) >= 2048 \
        and max(lengths) <= 8192 and all(x % 256 == 0 for x in lengths)
    assert 4200 < np.mean(lengths) < 4700
    for seed in (1, 2 ** 31 + 11):
        order = PREFILL.doc_order(t, seed, 48)
        for b in range(3):
            assert sorted(order[16 * b:16 * b + 16]) == sorted(lengths)
    assert PREFILL.doc_order(t, 1, 16) != PREFILL.doc_order(t, 2, 16)


def test_check_sample_one_document_a_length():
    """The compared documents are one of each length in the window, the
    longest among them, split at 4096 tokens into two halves of 8."""
    t = json.loads((BENCH / "traffic" / "longdoc-2k-8k.json").read_text())
    short, long = PREFILL.halves(t)
    assert len(short) == len(long) == 8
    assert max(short) < 4096 < min(long)
    for seed in (3, 2 ** 31 + 17):
        order = PREFILL.doc_order(t, seed, 37)
        picked = PREFILL.check_sample(seed, order)
        assert sorted(order[i] for i in picked) == sorted(set(order))
        assert max(order) in [order[i] for i in picked]
    a = PREFILL.check_sample(3, PREFILL.doc_order(t, 3, 37))
    b = PREFILL.check_sample(4, PREFILL.doc_order(t, 3, 37))
    assert a != b


def test_bf16_witness_rounds_activations_only():
    w = model.Weights({"a": torch.randn(8, 8)},
                      [stack.Leaf("a", (8, 8), False, "fan_in")], "bf16")
    x = torch.randn(4, 8)
    assert torch.equal(w.act(x), x.bfloat16().float())
    assert not torch.equal(w.act(x), x)
    assert torch.equal(model.Weights({}, [], None).act(x), x)


class _null_window:
    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False
