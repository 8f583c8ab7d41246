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
:func:`attend_chunked` is JAX's exact chunked attention in plain torch:
``runtime_flags.chunked_attention`` routes the plain path (CPU and fake
tensors, the dry-run among them) to it; on the card the path stays on
the ``flash_attention`` kernel, which never materialises S x S either.
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

from . import runtime_flags
from .common import (apply_mrope, apply_rope, dense_init, param, remat,
                     rope_freqs)
from .sharding import (DP_AXES, active_mesh, entry, fit, from_local,
                       model_ways, placed, pmax, psum, shard_batch,
                       to_local)

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
        return split_heads(y, nh, hd)

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


def split_heads(y, nh: int, hd: int):
    """(B, S, nh * hd) -> (B, S, nh, hd).  Under a mesh whose ``model``
    dim does not divide ``nh``, the projection is gathered over
    ``model`` first: DTensor cannot split a dim sharded inside a head."""
    if nh % model_ways():
        y = shard_batch(y)
    return y.reshape(*y.shape[:2], nh, hd)


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


def _chunk_tile(qf, kc, vc, m, l, acc, qpos, kpos, causal, window):
    """One (chunk_q, chunk_k) tile of the online softmax: the running max
    ``m``, sum ``l`` and context ``acc`` after the tile's keys."""
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kc.float())
    msk = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                     device=qf.device)
    if causal:
        msk = msk & (kpos <= qpos)
    if window > 0:
        msk = msk & (kpos > qpos - window)
    s = torch.where(msk, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p,
                                                vc.float())
    return m_new, l, acc


def attend_chunked(q, k, v, *, causal=True, window=0, q_offset=0,
                   chunk_q=512, chunk_k=1024):
    """Exact chunked attention (online softmax over tiles).

    JAX's ``attend_chunked``: the contract of :func:`attend` with a
    causal and window mask, but the (S, T) score matrix is never
    materialised: live memory is one (chunk_q, chunk_k) tile per (B, K,
    G), in fp32, over every tile in JAX's order (a fully masked tile
    adds nothing).  While gradients are on, each tile is rematerialised
    (``common.remat``, where JAX wraps it in ``jax.checkpoint``), so the
    backward pass does not keep the tiles either."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    cq, ck = min(chunk_q, S), min(chunk_k, T)
    if S % cq or T % ck:
        raise ValueError(f"attend_chunked: chunks ({cq}, {ck}) do not "
                         f"divide (S, T) = ({S}, {T})")
    scale = 1.0 / np.sqrt(D)
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)
    outs = []
    for qi in range(S // cq):
        qf = q[:, qi * cq:(qi + 1) * cq].reshape(B, cq, K, G, D).float() \
            * scale
        m = torch.full((B, K, G, cq), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, cq), device=q.device)
        acc = torch.zeros((B, K, G, cq, D), device=q.device)
        qpos = (qi * cq + ar_q + q_offset)[:, None]
        for ki in range(T // ck):
            sl = slice(ki * ck, (ki + 1) * ck)
            m, l, acc = remat(_chunk_tile, qf, k[:, sl], v[:, sl], m, l,
                              acc, qpos, (ki * ck + ar_k)[None, :], causal,
                              window)
        out = acc / l.clamp(min=1e-30)[..., None]          # (B,K,G,cq,D)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,cq,K,G,D)
    return torch.cat(outs, 1).reshape(B, S, H, D).to(q.dtype)


def on_shards(fn, q, k, v):
    """``fn(q, k, v)`` for attention (q (B, S, H, D), k/v (B, T, K, D) ->
    (B, S, H, D)), run on each rank's (batch, head) shard under an active
    mesh when q is a DTensor, else on the tensors themselves; returned
    with the heads merged, (B, S, H * D) (merged on each rank, so a
    gradient comes back to the rank's heads whatever their split).

    Attention is independent across rows and heads, so this is exact:
    JAX leaves the split to XLA, and the port states it (JAX's
    ``shard_map`` form), since DTensor has no strategy for the batched
    matmuls of a (batch, head)-sharded GQA attention.  Batch goes over
    the data axes that divide it and heads over ``model`` when it divides
    H (K/V replicated over ``model`` when it does not divide K, each rank
    taking the K/V heads its query heads read)."""
    from torch.distributed.tensor import DTensor

    mesh = active_mesh()
    B, S, H = q.shape[:3]
    if mesh is None or not isinstance(q, DTensor):
        return fn(q, k, v).reshape(B, S, -1)
    K = k.shape[2]
    G, n = H // K, model_ways()
    Hl = H // n
    h_ax = "model" if H % n == 0 and (K % n == 0 or Hl % G == 0
                                      or G % Hl == 0) else None
    kv_ax = h_ax if K % n == 0 else None
    q_spec = fit(q.shape, DP_AXES, None, h_ax, None)
    kv_spec = fit(k.shape, DP_AXES, None, kv_ax, None)
    ql = to_local(q, q_spec, mesh)
    kl, vl = to_local(k, kv_spec, mesh), to_local(v, kv_spec, mesh)
    if h_ax is not None and kv_ax is None:
        r = mesh.get_local_rank("model")
        lo, hi = r * Hl // G, ((r + 1) * Hl - 1) // G + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    out = fn(ql, kl, vl)
    return from_local(out.reshape(*out.shape[:2], -1), q_spec[:3], mesh,
                      (B, S, H * q.shape[3]))


def decode_on_shards(q, k, v, pos, lens, window=0, k_new=None,
                     v_new=None, tile=16):
    """One decode step's attention over DTensor caches under an active
    mesh, on each rank's (batch, head, sequence) shard of the cache as
    placed (``launch.dryrun.cache_pspecs``): q (B, H, D), k/v (B, T, K,
    D), pos (T,) replicated, lens a scalar or (B,) -> (B, H, D) DTensor.

    Given ``k_new``/``v_new`` (B, 1, K, D), the rank holding slot ``lens %
    T`` writes it (and every rank its replicated ``pos``) first, as the
    scalar decode step does.  On the card each rank runs the
    ``decode_attention`` kernel (``tile`` as the scalar step's) on its
    (batch, head) shard; a cache whose sequence is sharded raises there,
    since the kernel returns no softmax statistics to merge.  On CPU and
    fake tensors each rank's partial statistics (max, sum, context) over
    its slots are merged over the ranks that share the sequence:
    distributed flash-decode, which XLA derives from the reference's
    softmax over a sharded length.  Masking as ``decode_attention``'s."""
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.sharding import P, axis_sizes

    mesh = active_mesh()
    sizes = axis_sizes(mesh)
    dims = placed(k, mesh)
    b_ax, t_axes, k_ax = dims.get(0, []), dims.get(1, []), dims.get(2, [])
    T, D = k.shape[1], q.shape[2]
    q_spec = P(entry(b_ax), entry(k_ax), None)
    ql = to_local(q, q_spec, mesh)
    on_card = ql.device.type == "cuda"
    if on_card and t_axes:
        raise NotImplementedError(
            f"decode_on_shards: the cache's sequence is sharded over "
            f"{t_axes}; the decode_attention kernel returns no softmax "
            f"statistics to merge across them")
    kl, vl = k.to_local(), v.to_local()
    T_l = kl.shape[1]
    t0 = 0
    for a in t_axes:                          # major to minor
        t0 = t0 * sizes[a] + mesh.get_local_rank(a)
    t0 *= T_l
    if torch.is_tensor(lens) and lens.ndim == 1:      # a length a row
        lens_l = to_local(lens, P(entry(b_ax)), mesh)
    else:
        lens_l = lens.to_local() if isinstance(lens, DTensor) else lens
    pos_l = pos.to_local() if isinstance(pos, DTensor) else pos
    if k_new is not None:
        slot = lens_l % T
        li = (slot - t0).clamp(0, T_l - 1).reshape(1).long()
        inside = (slot >= t0) & (slot < t0 + T_l)
        n_spec = P(entry(b_ax), None, entry(k_ax), None)
        for c, new in ((kl, k_new), (vl, v_new)):
            new = to_local(new, n_spec, mesh).to(c.dtype)
            c.index_copy_(1, li, torch.where(inside, new,
                                             c.index_select(1, li)))
        pos_l.index_copy_(0, slot.reshape(1).long(), lens_l.reshape(1))
    if on_card:
        out = decode_attention(ql.contiguous(), kl.transpose(1, 2),
                               vl.transpose(1, 2), pos_l, lens_l,
                               window=window, tile=tile)
        return from_local(out, q_spec, mesh, q.shape)
    B_l, H_l, K_l = ql.shape[0], ql.shape[1], kl.shape[2]
    qf = ql.float().reshape(B_l, K_l, H_l // K_l, D) \
        * np.float32(1.0 / np.sqrt(D))
    s = torch.einsum("bkgd,btkd->bkgt", qf, kl.float())
    p_t = pos_l[t0:t0 + T_l][None, :]
    ln = lens_l.reshape(-1, 1)
    valid = (p_t >= 0) & (p_t <= ln)
    if window > 0:
        valid &= p_t > ln - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = pmax(s.amax(-1, keepdim=True), mesh, t_axes)
    p = torch.exp(s - m)
    denom = psum(p.sum(-1, keepdim=True), mesh, t_axes).clamp_min(1e-30)
    out = psum(torch.einsum("bkgt,btkd->bkgd", p, vl.float()), mesh,
               t_axes) / denom
    return from_local(out.reshape(B_l, H_l, D).to(ql.dtype), q_spec, mesh,
                      q.shape)


def _on_mesh(cache_t) -> bool:
    """A DTensor cache under an active mesh: the mesh decode path."""
    from torch.distributed.tensor import DTensor

    return active_mesh() is not None and isinstance(cache_t, DTensor)


def _chunked(S: int, causal: bool) -> bool:
    """JAX's condition for ``runtime_flags.chunked_attention``."""
    cq, ck = runtime_flags.chunk_q, runtime_flags.chunk_k
    return (runtime_flags.chunked_attention and causal and S >= 2 * cq
            and S % cq == 0 and S % ck == 0)


def self_attention(params: Attention, cfg, x, positions=None,
                   positions3=None, causal=True,
                   window: "int | None" = None):
    """Full prefill self-attention over x: (B, S, d), through the
    ``flash_attention`` kernel (its plain version on CPU tensors);
    ``positions3`` (3, B, S) drive M-RoPE in a Qwen2-VL config.  Under
    ``runtime_flags.chunked_attention`` (JAX's conditions) the plain path
    takes :func:`attend_chunked`; the card keeps the kernel."""
    S = x.shape[1]
    q, k, v = qkv_project(params, cfg, x, positions, positions3)
    w = cfg.sliding_window if window is None else window
    if _chunked(S, causal) and q.device.type != "cuda":
        ctx = on_shards(functools.partial(
            attend_chunked, causal=True, window=w,
            chunk_q=runtime_flags.chunk_q, chunk_k=runtime_flags.chunk_k),
            q, k, v)
    else:
        # as in the JAX model, the window applies to the causal mask only
        ctx = on_shards(functools.partial(
            attend_bshd, causal=causal, window=w if causal else 0), q, k, v)
    return ctx @ params.wo


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
    q = split_heads(q, cfg.num_heads, hd)
    if S > 1 or wants_graph(q, k, v):
        ctx = on_shards(functools.partial(attend_bshd, causal=False),
                        q, k, v)
    elif _on_mesh(k):
        T = k.shape[1]
        ctx = decode_on_shards(q[:, 0], k, v, _slot_positions(T, x.device)
                               if pos is None else pos,
                               T - 1 if lens is None else lens)
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
    if _on_mesh(k):
        ctx = decode_on_shards(q[:, 0], k, v, pos, cache_len, w, k_new,
                               v_new, cache["tile"])
        return ctx.reshape(B, 1, -1) @ params.wo, cache
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
