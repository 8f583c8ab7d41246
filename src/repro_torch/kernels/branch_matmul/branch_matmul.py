"""branch_matmul: grouped GEMM over the branches of a balanced group.

    x (G, M, K) · w (G, K, N) -> out (G, M, N)

The G branches of a §3.1-balanced parallel group (attention heads,
experts) run as one launch of ``csrc/branch_matmul.cu``, with the branch
index as a grid axis.  float32 or bfloat16 operands, fp32 accumulation
(plain FMA, no TF32, one chain per output in ascending k), output in
``x.dtype``; any M, K and N.  The kernel picks its block tile by shape:
64 x 64 where that gives every SM four blocks or more, else 32 x 64.

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
BLOCK_M = 32                   # fewest output rows per block (csrc: BM)

#: kernel launches since the last :func:`reset_launches`
launches = {"branch_matmul": 0}


def reset_launches() -> None:
    launches["branch_matmul"] = 0


def branch_matmul_plain(x, w):
    """Plain PyTorch version: ``einsum`` in fp32, cast to ``x.dtype``."""
    out = torch.einsum("gmk,gkn->gmn", x.float(), w.float())
    return out.to(x.dtype)


def branch_matmul(x, w):
    """Grouped GEMM: (G, M, K) x (G, K, N) -> (G, M, N)."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"branch_matmul: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}; expected (G, M, K) and "
                         f"(G, K, N)")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return branch_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"branch_matmul: no kernel for {x.device}")
    if w.device != x.device:
        raise ValueError(f"branch_matmul: w on {w.device}, x on {x.device}")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"branch_matmul: kernel takes float32 or bfloat16 "
                        f"operands of one type, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("branch_matmul: x and w must be contiguous")
    G, M, K = x.shape
    N = w.shape[2]
    if G > MAX_GRID_YZ or -(-M // BLOCK_M) > MAX_GRID_YZ:
        raise ValueError(f"branch_matmul: G={G}, M={M} exceed the grid")
    with unfilled():
        out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    lib = load("branch_matmul")
    rc = lib.branch_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                           G, M, K, N, KERNEL_DTYPES[x.dtype],
                           torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"branch_matmul: launch failed, CUDA error {rc}")
    launches["branch_matmul"] += 1
    return out
