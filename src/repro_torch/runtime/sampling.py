"""Token sampling for the serving engine.

Port of ``repro.runtime.sampling``: the same on-device functions, on
tensors, with no host round trip.
"""

from __future__ import annotations

import torch


def greedy_serving(logits):
    """(B, V) -> (B,) int32, argmax over bfloat16-quantised logits; the
    first index wins ties.

    Quantising first makes selection a step function with ~0.4 %
    relative quanta, so sub-quantum float noise (another reduction
    order, another backend) cannot change the winner unless the true
    gap straddles a quantum boundary."""
    return logits.to(torch.bfloat16).argmax(-1).to(torch.int32)


def select_tokens(logits, active, fallback):
    """Greedy next token with slot-validity gating.

    logits (B, V), active (B,) bool, fallback (B,) int32 -> (B,) int32.
    Inactive slot-table rows keep ``fallback`` (their previous token).
    """
    return torch.where(active, greedy_serving(logits),
                       fallback.to(torch.int32))


def logits_watchdog(logits, active):
    """(B, V) logits, (B,) active -> (B,) bool: active rows whose logits
    hold a non-finite value (NaN or inf) — a poisoned dispatch.  Read on
    the host together with the sampled tokens, so it costs no extra
    sync."""
    return active & ~torch.isfinite(logits).all(-1)


def poison_logits(logits, rows):
    """Overwrite ``rows`` (B,) bool rows of (B, V) logits with NaN — the
    fault plane's injection point, beside the watchdog that detects it."""
    return torch.where(rows[:, None],
                       torch.full_like(logits, float("nan")), logits)


def megastep_advance(logits, last, active, budget, n_forced, eos_ids,
                     step: int):
    """One megastep iteration's on-device sampling-state update.

    All tensor arguments are (B,); ``step`` is the loop index.  ``last``
    is the previous sampled token, ``active`` the rows that executed
    this step, ``budget`` the steps a row may still take, ``n_forced``
    the prompt tokens the row force-feeds (steps below ``n_forced - 1``
    emit mid-prompt argmaxes that must not trigger EOS), ``eos_ids`` the
    per-row EOS id (-1 for none).  Returns ``(nxt, active_next,
    budget_next)``: a row deactivates after its budget empties or it
    samples its EOS on a stream-token step.
    """
    nxt = select_tokens(logits, active, last)
    is_gen = step >= n_forced - 1
    eos_hit = active & is_gen & (eos_ids >= 0) & (nxt == eos_ids)
    budget_next = budget - active.to(torch.int32)
    active_next = active & (budget_next > 0) & ~eos_hit
    return nxt, active_next, budget_next
