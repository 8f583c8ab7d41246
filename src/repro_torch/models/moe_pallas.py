"""MoE expert FFN at a fixed capacity through the ``branch_matmul`` kernel.

Port of ``repro.models.moe_pallas``: routed tokens are bucketed per
expert into equal-capacity slots (the β-balance guarantee of §3.1 —
equal-size branches — realised by capacity padding), and the three
expert GEMMs run as three ``branch_matmul`` launches with the expert as
the grouped axis.  Pairs past the capacity drop (Switch semantics).  The
bucketing and the three launches are :mod:`.moe`'s, shared with the
dropless :func:`~.moe.moe_ragged`; the port's kernel takes any M, K and
N, so nothing is padded to the TPU kernel's blocks.
"""

from __future__ import annotations

from .mlp import mlp
from .moe import Buckets, expert_ffn, route

#: the capacity is rounded up to a multiple of this: JAX's default
#: ``block_m``, so the same pairs drop
CAPACITY_TILE = 8


def moe_branch_matmul(params, cfg, x, capacity_factor: float = 2.0):
    """x: (T, d) -> (y (T, d), aux).  Experts as branch-batched GEMMs at
    capacity ``max(int(T * k * capacity_factor / E), 1)`` rounded up to a
    multiple of :data:`CAPACITY_TILE` (JAX's rule)."""
    m = cfg.moe
    T = x.shape[0]
    E, k = m.num_experts, m.num_experts_per_tok
    w, idx, aux = route(params, cfg, x)
    cap = max(int(T * k * capacity_factor / E), 1)
    cap += (-cap) % CAPACITY_TILE
    b = Buckets(idx, E, cap)
    y = b.combine(expert_ffn(params, b.gather(x)), w, x.dtype)
    if params.shared is not None:
        y = y + mlp(params.shared, x)
    return y, aux
