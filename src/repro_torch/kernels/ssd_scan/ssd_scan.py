"""ssd_scan: the chunked Mamba-2 SSD from a zero state, in the models'
layout.

    x (b, S, H, P), dt (b, S, H), A (H,), B, C (b, S, G, N), chunk L
        -> y (b, S, H, P)

The full-sequence scan of ``mamba_block`` (``forward_lm`` /
``prefill_fn``) and of the Mamba2 DAG's fallback node.  Head ``h`` reads
group ``h // (H // G)`` of B and C.  The JAX wrapper
(``repro.kernels.ssd_scan.ops.ssd_scan_op``) repeats B and C over the
heads and transposes every operand into a pre-chunked ``(b, H, C, L,
.)`` layout before its Pallas kernel; the CUDA kernel
(``csrc/ssd_scan.cu``) takes the operands as they lie, by strides, with
the group broadcast as a stride — at b = 2, S = 2048, H = 32, N = 128
that saves two 67 MB fp32 copies a launch.  Any chunk length ``L >= 1``
that divides S is taken (the DAG exporter's rule ``chunk = S`` when S
is no multiple of the config's chunk), up to what shared memory holds
(the chunk-state kernel keeps 4 bytes a position beside ~103 KB of
tiles at N = 128: L up to ~32000; beyond, the launch is refused and the
wrapper raises).

One wrapper call runs four device kernels on the card, all named
``ssd_scan_*``: ``ssd_scan_chunk_state`` (every chunk's cumsum and own
state in parallel), ``ssd_scan_state_pass`` (the states carried across
the chunks, per (batch, head, element)), ``ssd_scan_chunk_scores``
(every chunk's C.B^T, once per group) and ``ssd_scan_chunk_out`` (every
chunk's output in parallel from the state carried in and the scores);
with one chunk (L = S) the pass is skipped.  The scratch — see
:func:`scratch_floats`; 16.8 MB of chunk states at b = 2, S = 2048,
H = 32 — is allocated here, with y, without deterministic mode's NaN
fill (the kernels write every element they read).

The wrapper checks its arguments, then runs :func:`ssd_scan_plain` (the
chunked algorithm of :mod:`.ref`) when the tensors lie on the CPU, and
otherwise launches the kernels on the current stream or raises: there
is no fallback.  The kernel computes in fp32 and takes fp32 only, as the
model path calls it.  A wrapper call that launches adds one to
:data:`launches`, however many device kernels it runs; nothing else
does.
"""

from __future__ import annotations

import ctypes

import torch

from .._args import aligned16, unfilled
from .._build import load
from .ref import ssd_chunked

MAX_D_STATE = 128              # csrc: kMaxN

#: kernel launches since the last :func:`reset_launches`
launches = {"ssd_scan": 0}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """Plain PyTorch version: ``ssd_chunked`` from a zero state, final
    state discarded (the kernel's function in another summation
    order)."""
    return ssd_chunked(x, dt, A, B, C, chunk)[0]


def scratch_floats(lib, b, S, H, G, P, N, chunk):
    """Floats of the kernels' three scratch buffers, as the library
    ``lib`` lays them out (``ssd_scan_scratch``): the chunk cumsums
    (b, H, S), the chunk states (b, S / L, H, N, P) and, per (batch,
    chunk, group), the lower-triangle tiles of C.B^T."""
    floats = (ctypes.c_longlong * 3)()
    lib.ssd_scan_scratch(b, S, H, G, P, N, int(chunk), floats)
    return tuple(floats)


def _check(x, dt, A, B, C, chunk):
    if x.ndim != 4 or B.ndim != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} and B "
                         f"{tuple(B.shape)} must be 4-d")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (dt.shape != (b, S, H) or A.shape != (H,) or B.shape[:2] != (b, S)
            or C.shape != B.shape or H % G):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")


def ssd_scan(x, dt, A, B, C, chunk: int):
    """x (b,S,H,P), dt (b,S,H), A (H,), B/C (b,S,G,N) -> y (b,S,H,P).

    On the card every operand is fp32; x, B and C need unit stride over
    their last axis (any other strides), A is contiguous, and y comes
    back contiguous."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    operands = dict(x=x, dt=dt, A=A, B=B, C=C)
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, expected "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: the kernel takes float32, {name} "
                            f"is {t.dtype}")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1 \
            or not A.is_contiguous():
        raise ValueError("ssd_scan: x, B and C need unit stride over their "
                         "last axis and A must be contiguous")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if N > MAX_D_STATE:
        raise ValueError(f"ssd_scan: d_state {N} > {MAX_D_STATE}")
    with unfilled():
        y = torch.empty((b, S, H, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = load("ssd_scan")
    with unfilled():
        cs, st, cb = (torch.empty(n, dtype=torch.float32, device=x.device)
                      for n in scratch_floats(lib, b, S, H, G, P, N, chunk))
    strides = (*x.stride()[:3], *dt.stride(), *B.stride()[:3],
               *C.stride()[:3])
    rc = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), cs.data_ptr(), st.data_ptr(),
        cb.data_ptr(), b, S, H, P, G, N, int(chunk), *strides,
        aligned16((x, B, C), *x.stride()[:3], *B.stride()[:3],
                  *C.stride()[:3], P, N),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: launch failed, CUDA error {rc}")
    launches["ssd_scan"] += 1
    return y
