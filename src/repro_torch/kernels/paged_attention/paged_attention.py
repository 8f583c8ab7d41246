"""Paged-attention kernels: block-table KV pools, read and written in place.

Two functions over the serving engine's physically paged KV cache — one
pool of fixed-size blocks per layer, ``(num_blocks + 1, block_size, K,
D)``, whose trailing row is the scratch block (the target of gated-off
writes and the filler of unallocated block-table entries):

* :func:`paged_decode_attention` — one query token per row against the
  blocks its table maps, with per-row ``cache_len`` masking and an
  optional sliding window (``csrc/paged_decode_attention.cu``);
* :func:`paged_append` — a chunk's K/V written straight into the
  blocks, invalid positions steered to the scratch row
  (``csrc/paged_append.cu``: a block of 64 threads per (token, slice of
  K * D), one element of K and of V a thread).

Each wrapper checks its arguments, then runs the plain PyTorch version
beside it when the tensors lie on the CPU, and otherwise launches its
CUDA kernel on the current stream or raises: there is no fallback.  A
launch adds one to :data:`launches`; nothing else does.

Shapes: q (B, H, D); pools (nb + 1, bs, K, D); block_tables (B, bpr)
int32; cache_len / lens / n_valid (B,) int32; out (B, H, D).
"""

from __future__ import annotations

import numpy as np
import torch

from .._args import (KERNEL_DTYPES, NEG_INF, aligned16, arrival_counters,
                     check_cuda, rows, unfilled)
from .._build import load

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"paged_decode_attention": 0, "paged_append": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# decode: one query token against the row's block table
# --------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, cache_len,
                                 window: int = 0):
    """Plain PyTorch version of :func:`paged_decode_attention`: gather the
    row's blocks, masked softmax in fp32 (the kernel's arithmetic, in
    another reduction order)."""
    B, H, D = q.shape
    _, bs, K, _ = k_pool.shape
    bpr = block_tables.shape[1]
    T = bpr * bs
    tables = block_tables.long()
    k = k_pool[tables].reshape(B, T, K, D).float()
    v = v_pool[tables].reshape(B, T, K, D).float()
    qf = q.float().reshape(B, K, H // K, D) * np.float32(1.0 / np.sqrt(D))
    s = torch.einsum("bkgd,btkd->bkgt", qf, k)
    lens = rows(cache_len, B, q)[:, None]
    t = torch.arange(T, device=q.device, dtype=torch.int32)[None, :]
    valid = t <= lens
    if window > 0:
        valid &= t > lens - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkd->bkgd", p, v) / denom
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                           window: int = 0):
    """q (B,H,D) x pools (nb+1,bs,K,D) via block_tables (B,bpr) -> (B,H,D).

    The pools must already hold the token at position ``cache_len[b]``.
    Table entries of unallocated logical blocks may point at any row
    (conventionally the scratch row): their positions are masked.  Rows
    whose output is used need ``cache_len[b] < bpr * bs``.
    """
    B, H, D = q.shape
    nb1, bs, K, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D or H % K:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} vs "
                         f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"paged_decode_attention: block_tables "
                         f"{tuple(block_tables.shape)} for batch {B}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            cache_len, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    lens = rows(cache_len, B, q)
    if block_tables.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables must be int32")
    if q.dtype != k_pool.dtype or q.dtype != v_pool.dtype:
        raise TypeError(f"paged_decode_attention: q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    check_cuda("paged_decode_attention",
                dict(q=q, k_pool=k_pool, v_pool=v_pool,
                     block_tables=block_tables, cache_len=lens), q.dtype)
    if D > 256:
        raise ValueError(f"paged_decode_attention: head dim {D} > 256")
    bpr = block_tables.shape[1]
    lib = load("paged_decode_attention")
    n_split = lib.decode_splits(D, H // K, KERNEL_DTYPES[q.dtype], bpr)
    with unfilled():
        out = torch.empty_like(q)
        scratch = torch.empty(B * H * n_split * (D + 2) if n_split > 1
                              else 0, dtype=torch.float32, device=q.device)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), arrival_counters(q.device, B * H).data_ptr(),
        B, H, K, D, bs, bpr, int(window),
        float(np.float32(1.0 / np.sqrt(D))), KERNEL_DTYPES[q.dtype],
        aligned16((q, k_pool, v_pool), D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: launch failed, CUDA "
                           f"error {rc}")
    launches["paged_decode_attention"] += 1
    return out


# --------------------------------------------------------------------------
# append: a chunk's K/V written straight into the blocks
# --------------------------------------------------------------------------

def _append_targets(block_tables, lens, n_valid, B, C, bs, scratch):
    """(B*C,) pool row, slot and keep mask of every (b, c) token; of the
    scratch-bound writes only the last in (b, c) order is kept, which is
    the one that survives the TPU kernel's in-order grid."""
    bpr = block_tables.shape[1]
    dev = block_tables.device
    c = torch.arange(C, device=dev)[None, :]
    p = lens.long()[:, None] + c
    ok = c < n_valid.long()[:, None]
    blk = (p // bs).clamp(0, bpr - 1)
    row = torch.where(ok, block_tables.long().gather(1, blk), scratch)
    slot = torch.where(ok, p % bs, 0)
    ok = ok.reshape(-1)
    order = torch.arange(B * C, device=dev)
    last_bad = torch.where(ok, -1, order).amax()
    return row.reshape(-1), slot.reshape(-1), ok | (order == last_bad)


def paged_append_plain(k_pool, v_pool, k_new, v_new, block_tables, lens,
                       n_valid):
    """Plain PyTorch version of :func:`paged_append` (in place)."""
    nb1, bs, K, D = k_pool.shape
    B, C = k_new.shape[:2]
    row, slot, keep = _append_targets(block_tables, rows(lens, B, k_pool),
                                      rows(n_valid, B, k_pool), B, C, bs,
                                      nb1 - 1)
    row, slot = row[keep], slot[keep]
    k_pool[row, slot] = k_new.reshape(B * C, K, D)[keep].to(k_pool.dtype)
    v_pool[row, slot] = v_new.reshape(B * C, K, D)[keep].to(v_pool.dtype)
    return k_pool, v_pool


def paged_append(k_pool, v_pool, k_new, v_new, block_tables, lens,
                 n_valid):
    """Write a chunk's K/V into the physical pools **in place**.

    k_new/v_new (B, C, K, D): token ``c`` of row ``b`` lands at cache
    position ``lens[b] + c``, i.e. pool row ``tables[b, p // bs]`` slot
    ``p % bs`` — provided ``c < n_valid[b]``; invalid positions (ragged
    chunk tails, rows not writing) go to the scratch row instead.  The
    pools are updated where they lie (the TPU kernel donates them
    through ``input_output_aliases``); returns ``(k_pool, v_pool)``.
    """
    nb1, bs, K, D = k_pool.shape
    B, C = k_new.shape[:2]
    if (v_pool.shape != k_pool.shape or k_new.shape[2:] != (K, D)
            or v_new.shape != k_new.shape):
        raise ValueError(f"paged_append: pools {tuple(k_pool.shape)}, new "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"paged_append: block_tables "
                         f"{tuple(block_tables.shape)} for batch {B}")
    if k_pool.device.type == "cpu":
        return paged_append_plain(k_pool, v_pool, k_new, v_new,
                                  block_tables, lens, n_valid)
    if k_pool.device.type != "cuda":
        raise ValueError(f"paged_append: no kernel for {k_pool.device}")
    lens = rows(lens, B, k_pool)
    n_valid = rows(n_valid, B, k_pool)
    if block_tables.dtype != torch.int32:
        raise TypeError("paged_append: block_tables must be int32")
    dt = k_pool.dtype
    if not (v_pool.dtype == k_new.dtype == v_new.dtype == dt):
        raise TypeError(f"paged_append: pools {dt}/{v_pool.dtype}, new "
                        f"{k_new.dtype}/{v_new.dtype}")
    check_cuda("paged_append",
                dict(k_pool=k_pool, v_pool=v_pool, k_new=k_new, v_new=v_new,
                     block_tables=block_tables, lens=lens, n_valid=n_valid),
                dt)
    lib = load("paged_append")
    rc = lib.paged_append(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), block_tables.data_ptr(), lens.data_ptr(),
        n_valid.data_ptr(), B, C, K * D, bs, block_tables.shape[1], nb1 - 1,
        KERNEL_DTYPES[dt], torch.cuda.current_stream(k_pool.device)
        .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_append: launch failed, CUDA error {rc}")
    launches["paged_append"] += 1
    return k_pool, v_pool
