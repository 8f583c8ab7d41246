"""Output projection helpers (tied / untied vocab heads).

Port of ``repro.models.vocab``: logits stay in the activation dtype.
"""

from __future__ import annotations

import torch


def lm_logits(params, cfg, hidden):
    """(B, S, d) -> (B, S, V): the full logits (the training loss)."""
    if cfg.tie_embeddings:
        return hidden @ params.embed.t()
    return hidden @ params.lm_head


def logits_last_token(params, cfg, hidden):
    """(B, S, d) -> (B, V) logits for the final position only."""
    last = hidden[:, -1, :]
    if cfg.tie_embeddings:
        return last @ params.embed.t()
    return last @ params.lm_head


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy in fp32 over the labels >= 0 (JAX's
    ``lm_loss`` / ``encdec_loss``: log-softmax in fp32, -1 labels
    masked, the sum over at least one)."""
    mask = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)
