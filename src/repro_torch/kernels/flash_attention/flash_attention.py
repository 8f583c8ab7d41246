"""flash_attention: causal / sliding-window attention over a sequence.

    q (B, H, S, D) x k, v (B, K, T, D) -> out (B, H, S, D)

Full-sequence self-attention of ``forward_lm`` / ``prefill_fn`` and of
the training losses.  The kernel computes the forward only (the TPU
kernel has no backward either); the wrapper is differentiable through
:class:`FlashAttentionFn` (the kernel forward, the plain version's
gradients).  Query head ``h`` reads KV
head ``h // (H // K)``; query and key positions both start at 0; key
``j`` is valid for query ``i`` iff (not ``causal`` or ``j <= i``) and
(``window == 0`` or ``j > i - window``).  ``causal=False`` and ``T !=
S`` (cross attention) are allowed.  A row with no valid key (``T == 0``,
or ``window > 0`` and ``i >= T + window - 1``) is the mean of V over all
T keys, as the JAX kernel's softmax over T scores of -1e30 gives.  The
JAX kernel's docstring also promises a kv validity length for
right-padded caches; its function takes none, and neither does this one.

The kernel (``csrc/flash_attention.cu``) takes every operand by strides
with unit stride over D, so :func:`attend_bshd` hands it the models'
``(B, S, H, D)`` activations as transposed views, without copies, and
gets its output back in that layout.  bfloat16 runs on the tensor cores
(``mma.sync``, fp32 accumulation, P rounded to bf16 before P . V);
float32 on the CUDA cores in full fp32.  Both take 64 query rows a block
and D <= 128.

The wrapper checks its arguments, then runs :func:`flash_attention_plain`
when the tensors lie on the CPU, and otherwise launches the kernel on
the current stream or raises: there is no fallback.  With grad mode on
and an input that requires grad it goes through
:class:`FlashAttentionFn`, so its output always carries the graph a
caller needs.  A launch adds one to :data:`launches`; nothing else
does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._args import (KERNEL_DTYPES, NEG_INF, plain_vjp, unfilled,
                     wants_graph)
from .._build import load

MAX_HEAD_DIM = 128             # csrc: kMaxD
BLOCK_Q = 64                   # query rows per block (csrc: kBQ, both kernels)
MAX_GRID_YZ = 65535            # CUDA's limit on gridDim.y and gridDim.z

#: kernel launches since the last :func:`reset_launches`
launches = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def _mask(S: int, T: int, causal: bool, window: int, device):
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """Plain PyTorch version: the (S, T) scores in fp32 (q scaled first),
    masked softmax (masked scores -1e30, so a row with no valid key
    weighs all T keys alike), P . V in fp32."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, K, H // K, S, D) \
        * np.float32(1.0 / np.sqrt(D))
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    s = torch.where(_mask(S, T, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B,H,S,D) x k,v (B,K,T,D) -> (B,H,S,D), each with any strides
    and unit stride over D; the output keeps q's memory layout.
    Differentiable with respect to q, k and v."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}; expected "
                         f"(B, H, S, D) and (B, K, T, D) with K | H")
    if wants_graph(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


def _forward(q, k, v, causal, window):
    """The plain version on the CPU, else the kernel's launch."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_attention: kernel takes float32 or "
                        f"bfloat16 operands of one type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"expected {q.device}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if max(H, B, -(-S // BLOCK_Q)) > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B={B}, H={H}, S={S} exceed "
                         f"the grid")
    with unfilled():
        out = torch.empty_like(q)       # q's layout (preserve_format)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.numel() and t.stride(3) != 1:     # T = 0: K/V never read
            raise ValueError(f"flash_attention: {name} needs unit stride "
                             f"over D, got strides {t.stride()}")
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = load("flash_attention")
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, H, K, S, T, D, int(bool(causal)),
        int(window), float(np.float32(1.0 / np.sqrt(D))),
        KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed, CUDA error "
                           f"{rc}")
    launches["flash_attention"] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is the kernel
    (the plain version on the CPU), the backward recomputes
    :func:`flash_attention_plain` on the saved q, k, v and returns its
    gradients (no kernel launch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        causal, window = ctx.mask
        grads = plain_vjp(
            lambda q, k, v: flash_attention_plain(q, k, v, causal, window),
            ctx.saved_tensors, ctx.needs_input_grad[:3], grad_out)
        return (*grads, None, None)


def attend_bshd(q, k, v, causal: bool = True, window: int = 0):
    """Adapter for the models' layout: q (B,S,H,D), k/v (B,T,K,D) ->
    (B,S,H,D), through transposed views (no copies on the card)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)
