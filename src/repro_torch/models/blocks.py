"""Decoder blocks: attention mixer + dense-MLP channel mix.

Port of ``repro.models.blocks``.  A block's *kind* is ``(mixer,
channel)``; :func:`block_pattern` and :func:`split_pattern` are copied
as they are.  The ``("attn", "dense")`` block is ported, for the
full-sequence forward (:func:`apply_block`) and the decode step on a
dense or a paged cache (:func:`decode_block`); MoE and Mamba blocks raise
until their slices.
"""

from __future__ import annotations

from torch import nn

from .attention import (Attention, decode_step_attention, init_kv_cache,
                        init_paged_kv_cache, self_attention)
from .common import Norm, norm
from .mlp import MLP, mlp


def block_pattern(cfg):
    """[(mixer, channel)] for each of cfg.num_layers blocks."""
    out = []
    for i in range(cfg.num_layers):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        if cfg.is_moe_layer(i):
            channel = "moe"
        elif cfg.d_ff > 0:
            channel = "dense"
        else:
            channel = "none"                      # mamba2: mixer-only blocks
        out.append((mixer, channel))
    return out


def split_pattern(pattern):
    """Factor ``pattern`` into (prefix_len, period) with minimal scan HLO:
    the suffix pattern[prefix:] repeats with ``period``; prefix layers are
    unrolled.  Greedy: smallest (prefix, period) lexicographically."""
    n = len(pattern)
    for prefix in range(0, min(n, 4) + 1):
        m = n - prefix
        if m == 0:
            return prefix, 1
        for period in range(1, min(m, 16) + 1):
            if m % period:
                continue
            if all(pattern[prefix + i] == pattern[prefix + i % period]
                   for i in range(m)):
                return prefix, period
    return n, 1                                    # fully unrolled fallback


def _check_kind(kind):
    mixer, channel = kind
    if mixer != "attn":
        raise NotImplementedError(
            f"{mixer} blocks arrive with the Mamba2/Jamba slice")
    if channel != "dense":
        raise NotImplementedError(
            f"{channel!r} channel mix arrives with the MoE slice")


class Block(nn.Module):
    def __init__(self, cfg, kind, gen, device, dtype):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.norm1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = Attention(cfg, gen, device, dtype)
        self.norm2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, gen, device, dtype)


def init_block(gen, cfg, kind, device, dtype) -> Block:
    return Block(cfg, kind, gen, device, dtype)


def apply_block(params: Block, cfg, x, positions=None, window=None):
    """Full-sequence (prefill) block.  x: (B, S, d) -> (x, aux loss 0).

    The JAX block also takes the MoE implementation and a mesh; MoE
    blocks raise at init here, until the MoE slice."""
    h = norm(params.norm1, x)
    x = x + self_attention(params.attn, cfg, h, positions, causal=True,
                           window=window)
    return x + mlp(params.mlp, norm(params.norm2, x)), 0.0


def init_block_cache(cfg, kind, batch, max_len, dtype, device, ring=False,
                     tile=16):
    """A dense per-row KV cache (see attention.init_kv_cache)."""
    _check_kind(kind)
    return init_kv_cache(cfg, batch, max_len, dtype, device, ring=ring,
                         tile=tile)


def init_paged_block_cache(cfg, kind, num_blocks, block_size, dtype,
                           device):
    """One physical block pool per attention layer (no batch axis: rows
    share it through block tables)."""
    _check_kind(kind)
    return init_paged_kv_cache(cfg, num_blocks, block_size, dtype, device)


def decode_block(params: Block, cfg, x, cache, cache_len, active=None,
                 block_tables=None):
    """Single-token decode block.  x: (B, 1, d).

    ``cache`` is a dense or a paged KV cache (see
    attention.decode_step_attention for the routing); ``active`` (B,)
    bool gates per-row cache writes; ``block_tables`` (B,
    blocks_per_seq) routes the paged pools and is ignored by dense
    caches.  ``active`` and a vector ``cache_len`` are device tensors
    that the decode megastep advances per row without a host round trip.
    """
    h = norm(params.norm1, x)
    y, cache = decode_step_attention(params.attn, cfg, h, cache, cache_len,
                                     active=active,
                                     block_tables=block_tables)
    x = x + y
    x = x + mlp(params.mlp, norm(params.norm2, x))
    return x, cache
