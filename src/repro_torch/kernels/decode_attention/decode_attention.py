"""decode_attention: one query token per row against a dense KV cache.

    q (B, H, D) x k, v (B, K, T, D), pos (T,), cache_len -> out (B, H, D)

The dense per-row cache of the round engine and of
``ContinuousEngine(paged=False)``, read in place.  The model keeps its
cache as ``(B, T, K, D)`` and passes ``cache.transpose(1, 2)``: the
kernel (``csrc/decode_attention.cu``) takes K and V by strides, so no
copy of the cache is made.  ``pos[t]`` is the absolute position held by
slot ``t`` (-1 = empty); ring caches hold them out of order.
``cache_len`` is a scalar or a (B,) vector of per-row positions, and
slot ``t`` of row ``b`` is valid iff ``0 <= pos[t] <= cache_len[b]``
and, with a window ``w``, ``pos[t] > cache_len[b] - w``.

``tile`` sets the kernel's reduction order: it splits the slots over
blocks, a fixed number of tiles of ``tile`` slots each, with the
arithmetic of the paged kernel (``csrc/decode_tile.cuh``).  With ``pos =
arange(T)`` and ``tile`` equal to a paged pool's block size, the result
is bit-identical to ``paged_decode_attention`` on the same K/V; a row's
result depends neither on the other rows nor on T past its last valid
slot.

The wrapper checks its arguments, then runs :func:`decode_attention_plain`
when the tensors lie on the CPU, and otherwise launches the kernel on
the current stream or raises: there is no fallback.  A launch adds one
to :data:`launches`; nothing else does.
"""

from __future__ import annotations

import numpy as np
import torch

from .._args import (KERNEL_DTYPES, NEG_INF, aligned16, arrival_counters,
                     check_cuda, rows, unfilled)
from .._build import load

#: kernel launches since the last :func:`reset_launches`
launches = {"decode_attention": 0}


def reset_launches() -> None:
    launches["decode_attention"] = 0


def decode_attention_plain(q, k, v, pos, cache_len, window: int = 0):
    """Plain PyTorch version of :func:`decode_attention`: masked softmax
    in fp32 over all T slots (the kernel's arithmetic in another
    reduction order; the same operations as the paged plain version)."""
    B, H, D = q.shape
    K = k.shape[1]
    kt = k.transpose(1, 2).float()                     # (B, T, K, D)
    vt = v.transpose(1, 2).float()
    qf = q.float().reshape(B, K, H // K, D) * np.float32(1.0 / np.sqrt(D))
    s = torch.einsum("bkgd,btkd->bkgt", qf, kt)
    lens = rows(cache_len, B, q)[:, None]
    p_t = pos.to(device=q.device, dtype=torch.int32)[None, :]
    valid = (p_t >= 0) & (p_t <= lens)
    if window > 0:
        valid &= p_t > lens - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkd->bkgd", p, vt) / denom
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention(q, k, v, pos, cache_len, window: int = 0,
                     tile: int = 16):
    """q (B,H,D) x k,v (B,K,T,D) (any strides, unit stride over D), pos
    (T,) int -> (B,H,D).  See the module docstring for the mask."""
    B, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    K, T = k.shape[1], k.shape[2]
    if pos.shape != (T,):
        raise ValueError(f"decode_attention: pos {tuple(pos.shape)} for "
                         f"{T} slots")
    if tile < 1:
        raise ValueError(f"decode_attention: tile must be >= 1, got {tile}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, cache_len, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    lens = rows(cache_len, B, q)
    if pos.dtype != torch.int32:
        raise TypeError("decode_attention: pos must be int32")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}")
    check_cuda("decode_attention", dict(q=q, pos=pos, cache_len=lens),
               q.dtype)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"expected {q.device}")
    if k.stride(3) != 1 or v.stride() != k.stride():
        raise ValueError(f"decode_attention: k and v need one set of "
                         f"strides with unit stride over D, got "
                         f"{k.stride()} / {v.stride()}")
    if D > 256:
        raise ValueError(f"decode_attention: head dim {D} > 256")
    lib = load("decode_attention")
    n_split = lib.decode_splits(D, H // K, KERNEL_DTYPES[q.dtype],
                                -(-T // int(tile)))
    with unfilled():
        out = torch.empty_like(q)
        scratch = torch.empty(B * H * n_split * (D + 2) if n_split > 1
                              else 0, dtype=torch.float32, device=q.device)
    rc = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        arrival_counters(q.device, B * H).data_ptr(), B, H, K, D, T,
        int(tile), k.stride(0), k.stride(1), k.stride(2), int(window),
        float(np.float32(1.0 / np.sqrt(D))), KERNEL_DTYPES[q.dtype],
        aligned16((q, k, v), D, *k.stride()[:3]),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: launch failed, CUDA error "
                           f"{rc}")
    launches["decode_attention"] += 1
    return out
