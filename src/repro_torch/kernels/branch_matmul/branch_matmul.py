"""branch_matmul: grouped GEMM over the branches of a balanced group.

    x (G, M, K) · w (G, K, N) -> out (G, M, N)

The G branches of a §3.1-balanced parallel group (attention heads,
experts) run as one launch of ``csrc/branch_matmul.cu``, with the branch
index as a grid axis; any M, K and N, output in ``x.dtype``.  float32
runs on the CUDA cores (plain FMA, no TF32, one chain per output in
ascending k; block tile 64 x 64 where that gives every SM four blocks or
more, else 32 x 64); bfloat16 on the tensor cores (``mma.sync``
m16n8k16, fp32 accumulation in ascending k; block tile 16, 64 or 128
rows by M).  In both, a row's bits depend on nothing but its own
operands.

``counts`` (optional, int32 ``(G,)`` on x's device): group g holds
``min(max(counts[g], 0), M)`` valid rows; the rows past them come out as
exact zeros and are not computed, and a group with no row reads none of
its weights — the per-group row counts of JAX's dropless MoE path
(``jax.lax.ragged_dot``'s ``group_sizes``).  The kernel reads them, the
host never does.

The wrapper runs :func:`branch_matmul_plain` when the tensors lie on the
CPU, and otherwise launches the kernel on the current stream or raises:
there is no fallback.  A launch adds one to :data:`launches`; nothing
else does.
"""

from __future__ import annotations

import torch

from .._args import KERNEL_DTYPES, unfilled
from .._build import load

MAX_GRID_YZ = 65535            # CUDA's limit on gridDim.y and gridDim.z
BLOCK_M = 32                   # fewest rows per fp32 block (csrc: BM; grid y)
BLOCK_N = 128                  # columns per bf16 block (csrc: BN; grid y)

#: kernel launches since the last :func:`reset_launches`
launches = {"branch_matmul": 0}


def reset_launches() -> None:
    launches["branch_matmul"] = 0


def branch_matmul_plain(x, w, counts=None):
    """Plain PyTorch version: ``einsum`` in fp32, cast to ``x.dtype``;
    with ``counts``, the rows past each group's count (clamped to
    [0, M]) set to zero."""
    out = torch.einsum("gmk,gkn->gmn", x.float(), w.float()).to(x.dtype)
    if counts is not None:
        M = x.shape[1]
        live = torch.arange(M, device=counts.device) \
            < counts.clamp(0, M)[:, None]
        out = torch.where(live[..., None], out, out.new_zeros(()))
    return out


def _check_counts(counts, x):
    if counts.dtype != torch.int32 or tuple(counts.shape) != (x.shape[0],):
        raise ValueError(f"branch_matmul: counts must be int32 of shape "
                         f"({x.shape[0]},), got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if counts.device != x.device:
        raise ValueError(f"branch_matmul: counts on {counts.device}, x on "
                         f"{x.device}")


def branch_matmul(x, w, counts=None):
    """Grouped GEMM: (G, M, K) x (G, K, N) -> (G, M, N); with ``counts``
    (int32 (G,)), only each group's first ``counts[g]`` rows, the rest
    zero."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"branch_matmul: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}; expected (G, M, K) and "
                         f"(G, K, N)")
    if counts is not None:
        _check_counts(counts, x)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return branch_matmul_plain(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"branch_matmul: no kernel for {x.device}")
    if w.device != x.device:
        raise ValueError(f"branch_matmul: w on {w.device}, x on {x.device}")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"branch_matmul: kernel takes float32 or bfloat16 "
                        f"operands of one type, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("branch_matmul: x and w must be contiguous")
    if counts is not None and not counts.is_contiguous():
        raise ValueError("branch_matmul: counts must be contiguous")
    G, M, K = x.shape
    N = w.shape[2]
    if G > MAX_GRID_YZ or -(-M // BLOCK_M) > MAX_GRID_YZ \
            or -(-N // BLOCK_N) > MAX_GRID_YZ:
        raise ValueError(f"branch_matmul: G={G}, M={M}, N={N} exceed the "
                         f"grid")
    with unfilled():
        out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    lib = load("branch_matmul")
    rc = lib.branch_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                           None if counts is None else counts.data_ptr(),
                           G, M, K, N, KERNEL_DTYPES[x.dtype],
                           torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"branch_matmul: launch failed, CUDA error {rc}")
    launches["branch_matmul"] += 1
    return out
