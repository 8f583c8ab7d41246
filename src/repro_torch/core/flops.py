"""Operator-level FLOP (MAC) estimators — paper Appendix A, Table 8.

The delegate cost model (§3.1) characterizes a region by its total compute
``F = Σ FLOPs(v)`` in MACs.  These estimators mirror Table 8:

=================  =========================  =====================================
Op class           Examples                   FLOPs per node
=================  =========================  =====================================
conv               Conv2D, DepthwiseConv2D    2·C_in·H_out·W_out·K_h·K_w·C_out
matmul             FullyConnected, MatMul     2·M·N·K
elementwise        Add, Mul, ReLU, Sub        output_size
pooling            AvgPool, MaxPool, Mean     H_out·W_out·K_h·K_w
misc               Reshape, Slice, Transpose  0  (optionally 0.5·output_size)
=================  =========================  =====================================

Unrecognized / non-compute-heavy ops are treated as 0-FLOP or assigned a
small constant workload (paper A.1).
"""

from __future__ import annotations

SMALL_CONSTANT_FLOPS = 1e3  # "small constant workload" for unknown ops


def conv2d_flops(c_in: int, h_out: int, w_out: int, k_h: int, k_w: int,
                 c_out: int, groups: int = 1) -> float:
    return 2.0 * (c_in // groups) * h_out * w_out * k_h * k_w * c_out


def matmul_flops(m: int, n: int, k: int, batch: int = 1) -> float:
    return 2.0 * batch * m * n * k


def elementwise_flops(output_size: int) -> float:
    return float(output_size)


def pooling_flops(h_out: int, w_out: int, k_h: int, k_w: int,
                  batch: int = 1, channels: int = 1) -> float:
    # Paper Table 8 lists the per-window cost; we scale by batch*channels so
    # region totals stay comparable across op classes.
    return float(h_out * w_out * k_h * k_w * batch * channels)


def misc_flops(output_size: int, count_half: bool = False) -> float:
    return 0.5 * output_size if count_half else 0.0


def attention_flops(batch: int, q_len: int, kv_len: int, num_q_heads: int,
                    head_dim: int) -> float:
    """softmax(QK^T)V as two batched matmuls (scores + context)."""
    return (matmul_flops(q_len, kv_len, head_dim, batch * num_q_heads)
            + matmul_flops(q_len, head_dim, kv_len, batch * num_q_heads))


def ssd_scan_flops(batch: int, seq: int, nheads: int, head_dim: int,
                   d_state: int) -> float:
    """Mamba2 SSD: per-step state update + output read-out, linear in seq."""
    return 2.0 * batch * seq * nheads * head_dim * d_state * 2
