"""Public wrappers around :func:`branch_matmul`.

``parallel_branches`` is the user-facing Parallax primitive: given the
inputs and weights of G balanced branches (the §3.1 refinement makes
them shape-compatible once M is padded), run them as one grouped GEMM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .branch_matmul import branch_matmul, branch_matmul_plain


def branch_matmul_op(x, w):
    """(G, M, K) x (G, K, N) -> (G, M, N) through the kernel (CUDA) or its
    plain version (CPU)."""
    return branch_matmul(x, w)


def parallel_branches(xs, ws):
    """Fuse per-branch matmuls ``x_i (M_i, K) @ w_i (K, N)``.

    The inputs are stacked with M zero-padded to the largest branch (the
    β-balance bound keeps that waste small) and run through one grouped
    kernel; the unpadded results are returned.  K and N need no padding:
    the kernel takes any K and N, and zero columns would only add exact
    zeros (the TPU kernel's 128-alignment is a Pallas constraint).
    """
    if not xs or len(xs) != len(ws):
        raise ValueError(f"parallel_branches: {len(xs)} inputs, "
                         f"{len(ws)} weights")
    K, N = ws[0].shape
    if any(tuple(w.shape) != (K, N) for w in ws) \
            or any(x.ndim != 2 or x.shape[1] != K for x in xs):
        raise ValueError("parallel_branches: every branch needs x (M_i, K) "
                         "and w (K, N) of one K and N")
    m_max = max(x.shape[0] for x in xs)
    x = torch.stack([x if x.shape[0] == m_max
                     else F.pad(x, (0, 0, 0, m_max - x.shape[0]))
                     for x in xs])
    out = branch_matmul(x, torch.stack(list(ws)))
    return [out[i, :xs[i].shape[0]] for i in range(len(xs))]


def grouped_branch_matmul(xs, ws):
    """Entry point of the schedule compiler (core/compile.py): the same
    function as :func:`parallel_branches`.  CUDA tensors go through the
    kernel, CPU tensors through its plain version, anything else raises;
    a failed build or launch raises too."""
    return parallel_branches(xs, ws)


__all__ = ["branch_matmul_op", "branch_matmul_plain",
           "grouped_branch_matmul", "parallel_branches"]
