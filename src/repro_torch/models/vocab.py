"""Output projection helpers (tied / untied vocab heads).

Port of ``repro.models.vocab``: logits stay in the activation dtype.
"""

from __future__ import annotations


def logits_last_token(params, cfg, hidden):
    """(B, S, d) -> (B, V) logits for the final position only."""
    last = hidden[:, -1, :]
    if cfg.tie_embeddings:
        return last @ params.embed.t()
    return last @ params.lm_head
