"""A run with its timed path broken underneath comes out not correct:
each fault these cells can have, planted in the port at tiny widths on
the CPU (the harness's look for a card skipped), and a sound run beside
them."""

from __future__ import annotations

import pytest
import torch

import harness
import run
import tiny
from repro_torch.models import attention, blocks, transformer


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


def _answer_altered(mp):
    """prefill: the answer's best logit handed to another token."""
    real = transformer.prefill_lm

    def fault(*a, **k):
        out = real(*a, **k).clone()
        best = out.argmax(-1)
        out[0, (best[0] + 1) % out.shape[1]] = out[0, best[0]] + 1.0
        return out
    mp.setattr(transformer, "prefill_lm", fault)


def _long_docs_altered(mp, over=32):
    """prefill: the answer altered as above, only for documents over
    ``over`` tokens (the tiny mix's longer half; 4096 on the card)."""
    real = transformer.prefill_lm

    def fault(params, cfg, tokens, *a, **k):
        out = real(params, cfg, tokens, *a, **k)
        if tokens.shape[1] <= over:
            return out
        out = out.clone()
        best = out.argmax(-1)
        out[0, (best[0] + 1) % out.shape[1]] = out[0, best[0]] + 1.0
        return out
    mp.setattr(transformer, "prefill_lm", fault)


def _moe_left_out(mp):
    """prefill: every MoE layer returns the stream unchanged."""
    mp.setattr(blocks, "moe_ragged",
               lambda p, cfg, x: (torch.zeros_like(x), 0.0))


def _state_unchanged(mp):
    """decode: the step writes nothing to the KV pool."""
    mp.setattr(attention, "paged_append", lambda *a, **k: None)


def _half_batch(mp):
    """decode: half of the rows left out, the other half's answers in
    their place."""
    real = transformer.decode_lm

    def fault(*a, **k):
        logits, caches = real(*a, **k)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, caches
    mp.setattr(transformer, "decode_lm", fault)


def _token_altered(mp):
    """decode: every fifth step's tokens altered where they are
    produced."""
    real = transformer.decode_lm
    calls = [0]

    def fault(*a, **k):
        logits, caches = real(*a, **k)
        calls[0] += 1
        if calls[0] % 5 == 0:
            logits = logits.clone()
            other = (logits.argmax(-1, keepdim=True) + 7) % logits.shape[1]
            logits.scatter_add_(1, other, torch.full_like(
                other, 50.0, dtype=logits.dtype))
        return logits, caches
    mp.setattr(transformer, "decode_lm", fault)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-moe-docs", _answer_altered),
    ("tiny-hybrid-docs", _answer_altered),
    ("tiny-moe-docs", _long_docs_altered),
    ("tiny-hybrid-docs", _long_docs_altered),
    ("tiny-moe-docs", _moe_left_out),
    ("tiny-hybrid-docs", _moe_left_out),
    ("tiny-moe-batch", _state_unchanged),
    ("tiny-moe-batch", _half_batch),
    ("tiny-moe-batch", _token_altered),
], ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_fails(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, lines, _ = run.run_cell(root, cell, 31, 2.5, False, "cpu")
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, cell):
    result, lines, _ = run.run_cell(root, cell, 2 ** 31 + 99, 2.5, False,
                                    "cpu")
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["jamba-longdoc-prefill",
                                  "dbrx-longdoc-prefill"])
def test_long_docs_fault_fails_on_card(card, monkeypatch, cell):
    """At the cell's own widths: answers altered only for documents over
    4096 tokens fail the longer half's number, the shorter half's
    holds."""
    root = harness.checkout_root()
    harness.setup_environment(root)
    _long_docs_altered(monkeypatch, over=4096)
    result, lines, _ = run.run_cell(root, cell, 2 ** 31 + 55, 8.0, False,
                                    card)
    print("\n".join(lines))
    assert not result["correct"], lines
    checks = result["checks"]
    assert all(harness.within(v) for k, v in checks.items()
               if k.endswith(".short")), lines
    assert not all(harness.within(v) for k, v in checks.items()
                   if k.endswith(".long")), lines
