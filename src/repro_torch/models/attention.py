"""Attention for the serving path: QKV projection and the paged decode step.

Port of ``repro.models.attention``.  Shapes (B = batch, S = query len,
H = q heads, K = kv heads, D = head_dim):

    q: (B, S, H, D)    k, v: (B, S, K, D)    pools: (nb + 1, bs, K, D)

The decode step writes the new token with the ``paged_append`` kernel
and attends with the ``paged_decode_attention`` kernel
(:mod:`repro_torch.kernels.paged_attention`), where the JAX reference
spells both out in jnp.  The dense-cache and scalar-``cache_len`` paths
arrive with the dense-cache slice, full-sequence attention with the
flash-attention slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.paged_attention import (paged_append,
                                                 paged_decode_attention)

from .common import apply_rope, dense_init, param, rope_freqs


class Attention(nn.Module):
    """wq (d, H*D), wk/wv (d, K*D), wo (H*D, d) — the JAX layout, so
    ``x @ w`` is the reference's einsum — plus the Qwen2 QKV biases."""

    def __init__(self, cfg, gen, device, dtype, d_model=None):
        super().__init__()
        d = d_model or cfg.d_model
        hd = cfg.resolved_head_dim()
        H, K = cfg.num_heads, cfg.num_kv_heads
        self.wq = param(dense_init(gen, (d, H * hd), device, dtype))
        self.wk = param(dense_init(gen, (d, K * hd), device, dtype))
        self.wv = param(dense_init(gen, (d, K * hd), device, dtype))
        self.wo = param(dense_init(gen, (H * hd, d), device, dtype))
        if cfg.qkv_bias:  # Qwen2 family uses QKV bias (arXiv:2407.10671)
            self.bq = param(torch.zeros(H * hd, device=device, dtype=dtype))
            self.bk = param(torch.zeros(K * hd, device=device, dtype=dtype))
            self.bv = param(torch.zeros(K * hd, device=device, dtype=dtype))
        else:
            self.bq = self.bk = self.bv = None
        self.register_buffer(
            "inv_freq", torch.from_numpy(rope_freqs(hd, cfg.rope_theta))
            .to(device), persistent=False)


def qkv_project(params: Attention, cfg, x, positions=None):
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,K,D) with RoPE applied."""
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE arrives with the Qwen2-VL slice")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads

    def proj(w, b, nh):
        y = x @ w
        if b is not None:
            y = y + b
        return y.reshape(B, S, nh, hd)

    q = proj(params.wq, params.bq, H)
    k = proj(params.wk, params.bk, K)
    v = proj(params.wv, params.bv, K)
    if positions is not None:
        q = apply_rope(q, positions, params.inv_freq)
        k = apply_rope(k, positions, params.inv_freq)
    return q, k, v


def init_paged_kv_cache(cfg, num_blocks: int, block_size: int, dtype,
                        device):
    """Physically paged KV cache: ONE pool of fixed-size blocks per layer.

    Layout ``(num_blocks + 1, block_size, K, D)`` — the trailing row is
    the *scratch block*: block-table entries of unallocated logical
    blocks point at it and gated-off writes land in it.  Block ids are
    handed out by :class:`repro_torch.runtime.kv_cache.BlockKVCache`; the
    same ``(B, blocks_per_seq)`` block table indexes every layer's pool.
    The kernels update the pools in place.
    """
    hd = cfg.resolved_head_dim()
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, hd)
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step_attention(params: Attention, cfg, x, cache, cache_len,
                          window: int = 0, active=None, block_tables=None):
    """One-token decode: x (B, 1, d) against a paged cache.

    ``cache_len`` (B,) int32: row ``b``'s new token has absolute position
    ``cache_len[b]``.  ``active`` (B,) bool gates the cache write per row
    (inactive rows write the scratch block).  ``block_tables`` (B,
    blocks_per_seq) int32 maps logical to physical blocks.  Every
    readable position (``t <= cache_len[b]``, window-clipped) was written
    by the row's own steps, and everything else is masked to an exact
    zero weight, so a new slot tenant needs no cache reset.

    Returns ``(out (B, 1, d), cache)``; the pools are updated in place.
    """
    if "k_pool" not in cache:
        raise NotImplementedError(
            "dense KV caches arrive with the dense-cache slice")
    if cache_len.ndim != 1 or block_tables is None:
        raise NotImplementedError(
            "paged caches take a vector cache_len (B,) and a (B, "
            "blocks_per_seq) block table; the scalar path arrives with "
            "the dense-cache slice")
    B = x.shape[0]
    q, k_new, v_new = qkv_project(params, cfg, x, cache_len[:, None])
    n_valid = (torch.ones_like(cache_len) if active is None
               else active.to(torch.int32))
    paged_append(cache["k_pool"], cache["v_pool"], k_new.contiguous(),
                 v_new.contiguous(), block_tables, cache_len, n_valid)
    ctx = paged_decode_attention(q[:, 0].contiguous(), cache["k_pool"],
                                 cache["v_pool"], block_tables, cache_len,
                                 window=window or cfg.sliding_window)
    out = ctx.reshape(B, 1, -1) @ params.wo
    return out, cache
