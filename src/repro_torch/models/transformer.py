"""Decoder-only language model: init, full-sequence forward / prefill,
single-token decode.

Port of ``repro.models.transformer``.  The JAX package scans a stacked
"period" of layers to keep XLA's compile time flat; here the layers are a
flat ``nn.ModuleList`` and every pass is a Python loop over them.  The
JAX forward also rematerialises each period for training (``remat``);
serving takes no gradients, so the port's forward has no remat: it
arrives with the training slice, as does the loss.

Parameters (:class:`LM`):
    embed (V, d)    final_norm    [lm_head (d, V) unless tied]
    layers: [Block, ...]          (cfg.num_layers)
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import (apply_block, block_pattern, decode_block, init_block,
                     init_block_cache, init_paged_block_cache,
                     split_pattern)
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


def embed_tokens(params: LM, cfg, tokens, frontend_embeds=None):
    """tokens: (B, S) int -> (B, S, d).  Frontend embeddings (vision
    patches, audio frames) arrive with the Qwen2-VL and Whisper slices."""
    if frontend_embeds is not None:
        raise NotImplementedError(
            "frontend embeddings arrive with the Qwen2-VL / Whisper slices")
    return params.embed[tokens]


def forward_lm(params: LM, cfg, tokens, frontend_embeds=None,
               positions3=None, window=None):
    """Prefill forward.  Returns (hidden (B, S, d), aux_loss).

    Every attention layer runs the ``flash_attention`` kernel and every
    Mamba layer the ``ssd_scan`` kernel (their plain versions on CPU
    tensors; a Mamba layer needs S to be a multiple of its chunk); MoE
    blocks raise at init until the MoE slice, so the aux loss is 0."""
    if positions3 is not None:
        raise NotImplementedError(
            "3-stream (M-RoPE) positions arrive with the Qwen2-VL slice")
    x = embed_tokens(params, cfg, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = 0.0
    for layer in params.layers:
        x, aux = apply_block(layer, cfg, x, positions, window)
        aux_total += aux
    return norm(params.final_norm, x), aux_total


def prefill_lm(params: LM, cfg, tokens, frontend_embeds=None,
               positions3=None, window=None):
    """Prefill: full forward returning last-token logits only (the full
    (B, S, V) logits tensor is never materialised)."""
    hidden, _ = forward_lm(params, cfg, tokens, frontend_embeds,
                           positions3, window=window)
    return logits_last_token(params, cfg, hidden)


def init_caches(cfg, batch, max_len, dtype, device, ring=False, tile=16):
    """Per layer: a dense ``(batch, slots, K, D)`` K/V cache with its
    ``pos`` array (see attention.init_kv_cache), or a Mamba layer's
    per-row SSM state and conv window (see ssm.init_mamba_cache)."""
    return [init_block_cache(cfg, kind, batch, max_len, dtype, device,
                             ring, tile)
            for kind in block_pattern(cfg)]


def init_paged_caches(cfg, batch, num_blocks, block_size, dtype, device):
    """Per attention layer one physical ``(num_blocks + 1, block_size, K,
    D)`` K/V pool pair, shared across slot-table rows through block
    tables; per Mamba layer the per-row state of ``batch`` rows."""
    return [init_paged_block_cache(cfg, kind, batch, num_blocks,
                                   block_size, dtype, device)
            for kind in block_pattern(cfg)]


def decode_lm(params: LM, cfg, caches, tokens, cache_len, active=None,
              block_tables=None):
    """One decode step.  tokens: (B, 1) -> (logits (B, V), caches).

    ``cache_len`` is a scalar (every row at the same position) or (B,)
    int32 per-row positions; ``active`` (B,) bool gates cache writes;
    ``block_tables`` (B, blocks_per_seq) int32 must be passed with the
    caches of :func:`init_paged_caches` and routes every layer's pool.

    Returns a new list: an attention layer's entry is its cache, updated
    in place; a Mamba layer's is a new dict of new tensors, so the list
    passed in still holds the state from before the step.
    """
    x = params.embed[tokens]                           # (B, 1, d)
    new = []
    for layer, cache in zip(params.layers, caches):
        x, cache = decode_block(layer, cfg, x, cache, cache_len, active,
                                block_tables)
        new.append(cache)
    hidden = norm(params.final_norm, x)
    return logits_last_token(params, cfg, hidden), new
