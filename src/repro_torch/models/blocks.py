"""Decoder blocks: attention / Mamba mixer + dense-MLP / no channel mix.

Port of ``repro.models.blocks``.  A block's *kind* is ``(mixer,
channel)`` with mixer in {"attn", "mamba"} and channel in {"dense",
"moe", "none"}; :func:`block_pattern` and :func:`split_pattern` are
copied as they are.  Attention and Mamba2 mixers, the dense MLP and the
mixer-only block (``"none"``, mamba2) are ported, for the full-sequence
forward (:func:`apply_block`) and the decode step on a dense or a paged
cache (:func:`decode_block`), in any interleave (the Jamba hybrid needs
only its MoE channel); MoE blocks raise until their slice.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import (Attention, decode_step_attention, init_kv_cache,
                        init_paged_kv_cache, self_attention)
from .common import Norm, norm
from .mlp import MLP, mlp
from .ssm import Mamba, init_mamba_cache, mamba_block, mamba_decode_step


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
    if kind[1] == "moe":
        raise NotImplementedError(
            "'moe' channel mix arrives with the MoE slice")


class Block(nn.Module):
    def __init__(self, cfg, kind, gen, device, dtype):
        super().__init__()
        _check_kind(kind)
        mixer, channel = kind
        self.kind = kind
        self.norm1 = Norm(cfg.d_model, cfg.norm_type, device)
        if mixer == "attn":
            self.attn = Attention(cfg, gen, device, dtype)
        else:
            self.mamba = Mamba(cfg, gen, device, dtype)
        if channel == "dense":
            self.norm2 = Norm(cfg.d_model, cfg.norm_type, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, gen, device,
                           dtype)


def init_block(gen, cfg, kind, device, dtype) -> Block:
    return Block(cfg, kind, gen, device, dtype)


def _channel_mix(params: Block, x):
    if params.kind[1] == "none":
        return x
    return x + mlp(params.mlp, norm(params.norm2, x))


def apply_block(params: Block, cfg, x, positions=None, window=None):
    """Full-sequence (prefill) block.  x: (B, S, d) -> (x, aux loss 0).

    The JAX block also takes the MoE implementation and a mesh; MoE
    blocks raise at init here, until the MoE slice."""
    h = norm(params.norm1, x)
    if params.kind[0] == "attn":
        y = self_attention(params.attn, cfg, h, positions, causal=True,
                           window=window)
    else:
        y = mamba_block(params.mamba, cfg, h)
    return _channel_mix(params, x + y), 0.0


def init_block_cache(cfg, kind, batch, max_len, dtype, device, ring=False,
                     tile=16):
    """A dense per-row KV cache (see attention.init_kv_cache), or a
    Mamba layer's per-row SSM state and conv window."""
    _check_kind(kind)
    if kind[0] == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    return init_kv_cache(cfg, batch, max_len, dtype, device, ring=ring,
                         tile=tile)


def init_paged_block_cache(cfg, kind, batch, num_blocks, block_size, dtype,
                           device):
    """One physical block pool per attention layer (no batch axis: rows
    share it through block tables); SSM state stays per-row."""
    _check_kind(kind)
    if kind[0] == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    return init_paged_kv_cache(cfg, num_blocks, block_size, dtype, device)


def decode_block(params: Block, cfg, x, cache, cache_len, active=None,
                 block_tables=None):
    """Single-token decode block.  x: (B, 1, d).

    ``cache`` is a dense or a paged KV cache (see
    attention.decode_step_attention for the routing), updated in place,
    or a Mamba layer's state and conv window, returned as a new dict of
    new tensors; ``active`` (B,) bool gates per-row cache writes (a
    Mamba row that is inactive keeps its old state: JAX's ``where(active,
    new, old)``); ``block_tables`` (B, blocks_per_seq) routes the paged
    pools and is ignored by dense and Mamba caches.  ``active`` and a
    vector ``cache_len`` are device tensors that the decode megastep
    advances per row without a host round trip.
    """
    h = norm(params.norm1, x)
    if params.kind[0] == "attn":
        y, cache = decode_step_attention(params.attn, cfg, h, cache,
                                         cache_len, active=active,
                                         block_tables=block_tables)
    else:
        y, new = mamba_decode_step(params.mamba, cfg, h, cache)
        if active is not None:
            new = {name: torch.where(
                active.reshape((-1,) + (1,) * (t.ndim - 1)), t,
                cache[name]) for name, t in new.items()}
        cache = new
    return _channel_mix(params, x + y), cache
