"""Attention: GQA / MHA / sliding window, full-sequence and decode step.

Port of ``repro.models.attention``.  Shapes (B = batch, S = query len,
T = kv len, H = q heads, K = kv heads, D = head_dim):

    q: (B, S, H, D)    k, v: (B, T, K, D)    pools: (nb + 1, bs, K, D)

Where the JAX model spells attention out in jnp, the port calls the
hand-written kernels, which take these layouts by strides:

* full-sequence self-attention (prefill, the Whisper encoder) and
  cross-attention over S > 1 queries — ``flash_attention``
  (:mod:`repro_torch.kernels.flash_attention`);
* the decode step on a dense per-row cache ``(B, slots, K, D)``, and
  Whisper's one-token cross-attention over the encoder's K/V —
  ``decode_attention`` (:mod:`repro_torch.kernels.decode_attention`);
* the decode step on the paged pool — ``paged_append`` and
  ``paged_decode_attention`` (:mod:`repro_torch.kernels.paged_attention`).

On CPU tensors each wrapper runs its plain PyTorch version.  The caches
are updated in place where the JAX package returns new arrays.
:func:`attend` and :func:`causal_mask` are the JAX model's plain
masked-softmax attention, kept as the reference the kernels are held to.
The chunked jnp attention (``attend_chunked``, switched on by
``runtime_flags.chunked_attention`` for the dry-run's XLA lowering) is
not ported: it waits with the dry-run tools.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.kernels._args import wants_graph
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import attend_bshd
from repro_torch.kernels.paged_attention import (paged_append,
                                                 paged_decode_attention)

from .common import apply_mrope, apply_rope, dense_init, param, rope_freqs

NEG_INF = -1e30


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


def qkv_project(params: Attention, cfg, x, positions=None,
                positions3=None):
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,K,D) with RoPE applied: by
    ``positions3`` (3, B, S) through M-RoPE when the config has
    ``mrope_sections`` (Qwen2-VL), else by ``positions`` (none: no
    RoPE)."""
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
    if cfg.mrope_sections:
        if positions3 is None:
            raise ValueError("M-RoPE needs 3-stream positions")
        q = apply_mrope(q, positions3, cfg.mrope_sections, params.inv_freq)
        k = apply_mrope(k, positions3, cfg.mrope_sections, params.inv_freq)
    elif positions is not None:
        q = apply_rope(q, positions, params.inv_freq)
        k = apply_rope(k, positions, params.inv_freq)
    return q, k, v


def _gqa_scores(q, k):
    """(B,S,H,D) x (B,T,K,D) -> (B,K,G,S,T) with G = H // K."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / np.sqrt(D)


def _gqa_context(p, v):
    """(B,K,G,S,T) x (B,T,K,D) -> (B,S,H,D)."""
    B, K, G, S, T = p.shape
    ctx = torch.einsum("bkgst,btkd->bskgd", p, v)
    return ctx.reshape(B, S, K * G, v.shape[-1])


def causal_mask(S: int, T: int, q_offset=0, window: int = 0, device=None):
    """(S, T) boolean mask. ``window`` > 0 adds sliding-window locality."""
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def attend(q, k, v, mask=None):
    """Masked softmax attention with GQA grouping; fp32 softmax (the JAX
    model's plain attention)."""
    s = _gqa_scores(q, k).float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_context(p.to(q.dtype), v)


def self_attention(params: Attention, cfg, x, positions=None,
                   positions3=None, causal=True,
                   window: "int | None" = None):
    """Full prefill self-attention over x: (B, S, d), through the
    ``flash_attention`` kernel (its plain version on CPU tensors);
    ``positions3`` (3, B, S) drive M-RoPE in a Qwen2-VL config."""
    B, S, _ = x.shape
    q, k, v = qkv_project(params, cfg, x, positions, positions3)
    w = cfg.sliding_window if window is None else window
    # as in the JAX model, the window applies to the causal mask only
    ctx = attend_bshd(q, k, v, causal=causal, window=w if causal else 0)
    return ctx.reshape(B, S, -1) @ params.wo


def cross_attention(params: Attention, cfg, x, k, v, pos=None, lens=None):
    """Decoder cross-attention: x (B, S, d) against K/V (B, T, K, D)
    precomputed from the encoder; a q projection with its optional bias
    and no RoPE, every key valid (JAX's ``attend`` with no mask).

    The one-token decode step (S = 1) attends through ``decode_attention``
    with every slot valid: ``pos`` = arange(T) int32 and ``lens`` = T - 1
    for every row (both kept in the caches by ``encdec.prefill_encdec``;
    built here when not given).  S > 1 goes through ``flash_attention``
    with ``causal=False``, as does S = 1 when a gradient is wanted
    (``decode_attention`` has none)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = x @ params.wq
    if params.bq is not None:
        q = q + params.bq
    q = q.reshape(B, S, cfg.num_heads, hd)
    if S > 1 or wants_graph(q, k, v):
        ctx = attend_bshd(q, k, v, causal=False)
    else:
        T = k.shape[1]
        if pos is None:
            pos = _slot_positions(T, x.device)
        if lens is None:
            lens = T - 1
        ctx = decode_attention(q[:, 0].contiguous(), k.transpose(1, 2),
                               v.transpose(1, 2), pos, lens)
    return ctx.reshape(B, S, -1) @ params.wo


# --------------------------------------------------------------------------
# decode path: single new token against a KV cache
# --------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, dtype, device,
                  ring: bool = False, tile: int = 16):
    """Dense KV cache with per-slot absolute-position bookkeeping.

    ``k``/``v`` are ``(batch, slots, K, D)``; ``pos`` (slots,) holds the
    absolute position in each slot (-1 = empty).  ``ring=True``
    allocates only ``sliding_window`` slots and wraps; a full cache is a
    ring that never wraps, so the scalar decode path handles both through
    ``pos``.  ``tile`` is the ``decode_attention`` kernel's tile: the
    serving engines pass their KV block size, so a dense cache reduces in
    the paged pool's order and the two agree bit for bit on the card.
    """
    hd = cfg.resolved_head_dim()
    slots = max_len
    if ring:
        if cfg.sliding_window <= 0:
            raise ValueError("ring cache needs a sliding window")
        slots = min(max_len, cfg.sliding_window)
    shape = (batch, slots, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device),
            "tile": int(tile)}


def fill_kv_cache(cache, k, v, start: int = 0):
    """Write a prefill segment k/v (B, S, K, D) into the cache at
    ``start`` (absolute positions start..start+S-1; no wrapping — prefill
    must fit the allocated slots).  In place; returns ``cache``."""
    S = k.shape[1]
    if start < 0 or start + S > cache["k"].shape[1]:
        raise ValueError(f"fill_kv_cache: positions {start}..{start + S - 1}"
                         f" outside {cache['k'].shape[1]} slots")
    cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
    cache["pos"][start:start + S] = torch.arange(
        start, start + S, dtype=torch.int32, device=cache["pos"].device)
    return cache


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


@functools.lru_cache(maxsize=32)
def _slot_positions(slots: int, device: torch.device) -> torch.Tensor:
    """arange(slots) as int32 on ``device``: the ``pos`` of a cache whose
    slot t holds position t (never written to)."""
    return torch.arange(slots, dtype=torch.int32, device=device)


def decode_step_attention(params: Attention, cfg, x, cache, cache_len,
                          positions3=None, window: int = 0, active=None,
                          block_tables=None):
    """One-token decode: x (B, 1, d) against a KV cache.

    ``cache_len`` is the number of tokens already in the cache; the new
    token has absolute position ``cache_len``.

    *Scalar* ``cache_len``: every row is at the same position; the token
    goes to slot ``cache_len % slots`` of a dense cache (ring semantics
    through the per-slot ``pos`` array, which this step updates).

    *Vector* ``cache_len`` (B,): each row sits at its own position — the
    continuous-batching serving path.  On a dense cache row ``b`` writes
    slot ``cache_len[b]`` (slot t holds position t; ``pos`` is unused).
    On a paged cache (``"k_pool"`` in ``cache``) ``block_tables`` (B,
    blocks_per_seq) int32 maps logical to physical blocks.  ``active``
    (B,) bool gates the cache write per row (inactive rows leave the
    dense cache untouched, or write the paged pool's scratch block).
    Every readable position (``t <= cache_len[b]``, window-clipped) was
    written by the row's own steps and everything else is masked to an
    exact zero weight, so a new slot tenant needs no cache reset.

    ``positions3`` (3, B, 1) rotate q and k in a Qwen2-VL config; left
    out, each path broadcasts its own positions to the three streams, as
    JAX's do (the serving engines pass none).

    Returns ``(out (B, 1, d), cache)``; the cache is updated in place.
    """
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x.device)
    w = window or cfg.sliding_window
    if "k_pool" in cache:
        if cache_len.ndim != 1 or block_tables is None:
            raise ValueError(
                "paged caches require vector cache_len (B,) and a "
                "(B, blocks_per_seq) block table")
        return _decode_step_attention_paged(params, cfg, x, cache,
                                            cache_len, block_tables,
                                            positions3, w, active)
    if cache_len.ndim == 1:
        return _decode_step_attention_vec(params, cfg, x, cache, cache_len,
                                          positions3, w, active)
    if active is not None:
        raise ValueError(
            "per-row `active` gating requires vector cache_len (B,): the "
            "scalar path writes every row's cache unconditionally")
    B = x.shape[0]
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    positions = cache_len.reshape(1, 1).expand(B, 1)
    if positions3 is None and cfg.mrope_sections:
        positions3 = positions.expand(3, B, 1)
    q, k_new, v_new = qkv_project(params, cfg, x, positions, positions3)
    slot = (cache_len % k.shape[1]).reshape(1).long()
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    pos.index_copy_(0, slot, cache_len.reshape(1))
    ctx = decode_attention(q[:, 0].contiguous(), k.transpose(1, 2),
                           v.transpose(1, 2), pos, cache_len, window=w,
                           tile=cache["tile"])
    return ctx.reshape(B, 1, -1) @ params.wo, cache


def _decode_step_attention_vec(params: Attention, cfg, x, cache, cache_len,
                               positions3, window, active):
    """Vector-``cache_len`` decode step on a dense cache.

    PRECONDITION (not checked here: the serving engines enforce it by
    validating ``max_context``): every active row has ``cache_len[b] <
    slots`` — a NON-ring cache where slot t holds position t.  The write
    goes by index, in place: a row that is inactive, or whose
    ``cache_len`` lies outside the slots (an idle row may keep a stale
    ``cache_len == slots``), writes its slot's old value back, which
    leaves the cache exactly as the JAX model's masked rewrite does.
    """
    B = x.shape[0]
    k, v = cache["k"], cache["v"]
    slots = k.shape[1]
    positions = cache_len[:, None]                        # (B, 1)
    if positions3 is None and cfg.mrope_sections:
        positions3 = positions.expand(3, B, 1)
    q, k_new, v_new = qkv_project(params, cfg, x, positions, positions3)
    write = (cache_len >= 0) & (cache_len < slots)
    if active is not None:
        write = write & active
    idx = cache_len.clamp(0, slots - 1).long()
    rows = torch.arange(B, device=x.device)
    for c, new in ((k, k_new), (v, v_new)):
        c[rows, idx] = torch.where(write[:, None, None],
                                   new[:, 0].to(c.dtype), c[rows, idx])
    ctx = decode_attention(q[:, 0].contiguous(), k.transpose(1, 2),
                           v.transpose(1, 2),
                           _slot_positions(slots, x.device), cache_len,
                           window=window, tile=cache["tile"])
    return ctx.reshape(B, 1, -1) @ params.wo, cache


def _decode_step_attention_paged(params: Attention, cfg, x, cache,
                                 cache_len, block_tables, positions3,
                                 window, active):
    """Vector decode step over a physically paged KV pool: the new token
    is written by ``paged_append`` (inactive rows write the scratch
    block), then ``paged_decode_attention`` attends through the table."""
    B = x.shape[0]
    positions = cache_len[:, None]                        # (B, 1)
    if positions3 is None and cfg.mrope_sections:
        positions3 = positions.expand(3, B, 1)
    q, k_new, v_new = qkv_project(params, cfg, x, positions, positions3)
    n_valid = (torch.ones_like(cache_len) if active is None
               else active.to(torch.int32))
    paged_append(cache["k_pool"], cache["v_pool"], k_new.contiguous(),
                 v_new.contiguous(), block_tables, cache_len, n_valid)
    ctx = paged_decode_attention(q[:, 0].contiguous(), cache["k_pool"],
                                 cache["v_pool"], block_tables, cache_len,
                                 window=window)
    out = ctx.reshape(B, 1, -1) @ params.wo
    return out, cache
