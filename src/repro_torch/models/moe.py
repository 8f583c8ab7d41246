"""Mixture-of-Experts: routing, dropless expert compute on the grouped
kernel, and the dense oracle.

Port of ``repro.models.moe``.  Two execution paths share one parameter
layout (:class:`MoE`):

* :func:`moe_dense` — every expert processes every token, gate-weighted
  combine.  O(E) FLOPs; the JAX model's path for E <= 4 (the reduced
  smoke configs).  Plain ``einsum``s, as in JAX (no kernel there).
* :func:`moe_ragged` — single-shard *dropless* compute, the JAX model's
  path for E > 4.  JAX sorts the (token, choice) pairs by expert and runs
  ``jax.lax.ragged_dot`` with the experts' row counts as ``group_sizes``;
  the port buckets the pairs by expert into ``(E, cap, d)`` at a capacity
  where nothing drops and runs the three expert GEMMs as three launches
  of the hand-written ``branch_matmul`` kernel
  (:mod:`repro_torch.kernels.branch_matmul`), the contraction's kernel in
  the JAX package, with the same row counts: each expert computes its
  routed rows only, and an expert with none reads none of its weights.
  The E experts are the β-balanced parallel branches of §3.1.  Equal to
  JAX's up to summation order.

Expert parallelism (JAX ``moe_ep``, ``shard_map`` over a mesh) waits for
the mesh tools (ROADMAP §1 item 7).

Determinism: the pairs are ordered by a stable sort on the expert id
alone, the buckets are filled and emptied by gathers (no scatter-add),
and each token's k contributions are added in a fixed order of its
choices, so a row's output does not depend on the other rows, the
counts or the capacity (the kernel sums each output in one fixed order:
in bf16 one fixed sequence of tensor-core steps over ascending k, in
fp32 one FMA chain, whatever the tile).

Parameters:
    router (d, E), fp32      w_gate / w_up (E, d, f)      w_down (E, f, d)
    shared (optional): a SwiGLU :class:`~.mlp.MLP` of width
    ``f * num_shared_experts``, always active (Kimi K2).

The router stays in fp32 whatever the model dtype: JAX reads its fp32
master at use, and a bf16 router would move near-tied routing decisions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.branch_matmul import branch_matmul

from .common import dense_init, param
from .mlp import MLP, mlp

#: the dropless capacity is T up to this many tokens (a decode step of up
#: to 32 rows never reads back to the host), else the largest group
#: rounded up to a multiple of it
CAPACITY_STEP = 32


class MoE(nn.Module):
    def __init__(self, cfg, gen, device, dtype):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
        self.router = param(dense_init(gen, (d, E), device, torch.float32))
        self.w_gate = param(dense_init(gen, (E, d, f), device, dtype))
        self.w_up = param(dense_init(gen, (E, d, f), device, dtype))
        self.w_down = param(dense_init(gen, (E, f, d), device, dtype))
        self.shared = (MLP(d, f * m.num_shared_experts, "silu", gen, device,
                           dtype) if m.num_shared_experts else None)


def route(params: MoE, cfg, x):
    """Top-k routing.  x: (T, d) -> (weights (T, k) in x.dtype, idx (T, k)
    int64, aux loss (fp32 scalar))."""
    m = cfg.moe
    logits = x.float() @ params.router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.num_experts_per_tok, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)        # renormalize
    # Switch-style load-balance auxiliary loss: E * sum_e f_e * p_e
    E = m.num_experts
    f_e = F.one_hot(idx, E).float().sum(1).mean(0)
    p_e = probs.mean(0)
    aux = E * (f_e * p_e).sum() * m.aux_loss_weight
    return w.to(x.dtype), idx, aux


class Buckets:
    """The (token, choice) pairs of a routing, laid out by expert.

    ``src`` (E, cap): the token whose row fills each bucket slot;
    ``valid`` (E, cap): the slot holds a pair; ``pos`` (T, k): each
    pair's slot in its expert's bucket, in the order the pairs appear
    token by token (JAX's cumsum rule); ``keep`` (T, k): ``pos < cap``
    (a pair past the capacity drops); ``counts`` (E,): pairs routed to
    each expert, dropped ones included.  ``cap=None`` takes
    :func:`dropless_capacity`.
    """

    def __init__(self, idx, E: int, cap: "int | None" = None):
        T, k = idx.shape
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)       # by expert, then pair
        experts = torch.arange(E, device=idx.device)
        sorted_e = flat[order]
        starts = torch.searchsorted(sorted_e, experts)
        self.counts = torch.searchsorted(sorted_e, experts,
                                         right=True) - starts
        if cap is None:
            cap = dropless_capacity(self.counts, T)
        self.cap = cap
        slot = torch.arange(cap, device=idx.device)
        self.valid = slot < self.counts[:, None]
        first = (starts[:, None] + slot).clamp(max=T * k - 1)
        self.src = order[first] // k
        rank = torch.argsort(order)                    # the inverse order
        self.pos = (rank - starts[flat]).reshape(T, k)
        self.keep = self.pos < cap
        self.idx = idx

    def gather(self, x):
        """x (T, d) -> (E, cap, d): each slot's token row, zeros where the
        slot is empty."""
        return torch.where(self.valid[..., None], x[self.src],
                           x.new_zeros(()))

    def combine(self, y_b, w, dtype):
        """y_b (E, cap, d) bucket outputs -> (T, d): each token's k rows
        ``y_b[e_j, pos_j]`` weighted by its gates ``w`` (T, k) in
        ``dtype``, added to zeros in the order of j; a dropped pair adds
        zero."""
        rows = y_b[self.idx, self.pos.clamp(max=self.cap - 1)]  # (T, k, d)
        contrib = torch.where(self.keep[..., None], rows * w[..., None],
                              rows.new_zeros(()))
        y = torch.zeros(rows.shape[0], rows.shape[2], dtype=dtype,
                        device=rows.device)
        for j in range(contrib.shape[1]):
            y = y + contrib[:, j]
        return y


def dropless_capacity(counts, T: int) -> int:
    """Bucket rows at which no pair drops.  Top-k picks k distinct
    experts per token, so no expert gets more than T pairs: up to
    :data:`CAPACITY_STEP` tokens (every decode step at B <= 32) the
    capacity is T, with no read back to the host; above that, the
    largest group, read once per layer and rounded up to the step, so a
    prefill never pads to E * T rows."""
    if T <= CAPACITY_STEP:
        return T
    return -(-int(counts.max()) // CAPACITY_STEP) * CAPACITY_STEP


def expert_ffn(params: MoE, xb, counts=None):
    """Grouped SwiGLU over expert buckets: xb (E, cap, d) -> (E, cap, d),
    three ``branch_matmul`` launches (weights cast to xb's dtype).  With
    ``counts`` (int32 (E,), at most cap), each expert's first counts[e]
    rows only; the rows past them come out zero, and get zero
    gradient."""
    dt = xb.dtype
    g = branch_matmul(xb, params.w_gate.to(dt), counts)
    u = branch_matmul(xb, params.w_up.to(dt), counts)
    return branch_matmul(F.silu(g) * u, params.w_down.to(dt), counts)


def moe_ragged(params: MoE, cfg, x):
    """Dropless single-shard MoE.  x: (T, d) -> (y (T, d), aux)."""
    w, idx, aux = route(params, cfg, x)
    b = Buckets(idx, cfg.moe.num_experts)
    counts = b.counts.clamp(max=b.cap).int()
    y = b.combine(expert_ffn(params, b.gather(x), counts), w, x.dtype)
    if params.shared is not None:
        y = y + mlp(params.shared, x)
    return y, aux


def moe_dense(params: MoE, cfg, x):
    """All-experts einsum (the smoke configs' path).  x: (T, d)."""
    m = cfg.moe
    w, idx, aux = route(params, cfg, x)
    dt = x.dtype
    g = torch.einsum("td,edf->tef", x, params.w_gate.to(dt))
    u = torch.einsum("td,edf->tef", x, params.w_up.to(dt))
    ys = torch.einsum("tef,efd->ted", F.silu(g) * u, params.w_down.to(dt))
    gates = torch.zeros(x.shape[0], m.num_experts, dtype=dt,
                        device=x.device).scatter(1, idx, w)
    y = torch.einsum("ted,te->td", ys, gates)
    if params.shared is not None:
        y = y + mlp(params.shared, x)
    return y, aux


def moe_ep(params: MoE, cfg, x, mesh=None, axis: str = "model"):
    """Expert parallelism over a device mesh: waits for the mesh tools
    (ROADMAP §1 item 7)."""
    raise NotImplementedError(
        "moe_ep (expert parallelism over a mesh) waits for the mesh tools, "
        "ROADMAP §1 item 7")
