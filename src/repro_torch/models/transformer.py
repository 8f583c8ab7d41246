"""Decoder-only language model: init and single-token decode.

Port of ``repro.models.transformer``.  The JAX package scans a stacked
"period" of layers to keep XLA's compile time flat; here the layers are a
flat ``nn.ModuleList`` and decode is a Python loop over them.

Parameters (:class:`LM`):
    embed (V, d)    final_norm    [lm_head (d, V) unless tied]
    layers: [Block, ...]          (cfg.num_layers)
"""

from __future__ import annotations

from torch import nn

from .blocks import (block_pattern, decode_block, init_block,
                     init_paged_block_cache, split_pattern)
from .common import Norm, embed_init, norm, param
from .vocab import logits_last_token


def structure(cfg):
    pattern = block_pattern(cfg)
    prefix_len, period = split_pattern(pattern)
    n_rep = (cfg.num_layers - prefix_len) // period
    return pattern, prefix_len, period, n_rep


class LM(nn.Module):
    def __init__(self, cfg, gen, device, dtype):
        super().__init__()
        pattern = block_pattern(cfg)
        self.embed = param(embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                      device, dtype))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.lm_head = None if cfg.tie_embeddings else param(
            embed_init(gen, (cfg.d_model, cfg.vocab_size), device, dtype))
        self.layers = nn.ModuleList(
            init_block(gen, cfg, pattern[i], device, dtype)
            for i in range(cfg.num_layers))


def init_lm(gen, cfg, device, dtype) -> LM:
    """Random init from ``gen`` (a ``torch.Generator`` on ``device``);
    ``gen=None`` allocates zeros for the params bridge to fill."""
    return LM(cfg, gen, device, dtype)


def init_paged_caches(cfg, batch, num_blocks, block_size, dtype, device):
    """One physical ``(num_blocks + 1, block_size, K, D)`` K/V pool pair
    per layer, shared across slot-table rows through block tables."""
    del batch                      # attention-only: no per-row state
    return [init_paged_block_cache(cfg, kind, num_blocks, block_size,
                                   dtype, device)
            for kind in block_pattern(cfg)]


def decode_lm(params: LM, cfg, caches, tokens, cache_len, active=None,
              block_tables=None):
    """One decode step.  tokens: (B, 1) -> (logits (B, V), caches).

    ``cache_len`` (B,) int32 per-row positions, ``active`` (B,) bool
    gates cache writes, ``block_tables`` (B, blocks_per_seq) int32 routes
    every layer's pool.  The pools are updated in place and returned.
    """
    x = params.embed[tokens]                           # (B, 1, d)
    for layer, cache in zip(params.layers, caches):
        x, _ = decode_block(layer, cfg, x, cache, cache_len, active,
                            block_tables)
    hidden = norm(params.final_norm, x)
    return logits_last_token(params, cfg, hidden), caches
