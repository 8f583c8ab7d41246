"""Mixture-of-Experts: routing, dropless expert compute on the grouped
kernel, and the dense oracle.

Port of ``repro.models.moe``.  Three execution paths share one parameter
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

* :func:`moe_ep` — expert parallelism over a ``DeviceMesh``: experts
  sharded over the ``model`` axis, each rank computing on its local
  shards (JAX's ``shard_map``), tokens exchanged by capacity-based
  all-to-all (drop-on-overflow) or replicated with the outputs
  all-reduced (dropless).  Its local expert FFN is the same three
  ``branch_matmul`` launches.

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

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.branch_matmul import branch_matmul

from .common import dense_init, param
from .mlp import MLP, mlp
from .sharding import from_local, psum, to_local

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

    ``src`` (E, cap): the token whose row fills each bucket slot
    (``pair``: its flat pair index ``t * k + j``);
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
        self.pair = order[first]                       # flat (t * k + j)
        self.src = self.pair // k
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


# --------------------------------------------------------------------------
# Expert parallelism (JAX's shard_map over the `model` axis)
# --------------------------------------------------------------------------

def moe_ep(params: MoE, cfg, x, mesh, axis: str = "model", stats=None):
    """Expert-parallel MoE dispatcher.  x: (T, d) global tokens.

    Two regimes (both shard experts over ``axis``), JAX's:

    * **a2a** (train/prefill, many tokens): tokens are split over every
      mesh axis and travel to their expert's shard via capacity-based
      all-to-all — Switch-style, minimal redundant compute.
    * **replicated** (decode, few tokens): tokens are replicated over the
      expert axis; each shard computes only its local experts' share and
      the outputs are summed over ``axis`` — no dispatch buffers,
      dropless, one (T, d) all-reduce.

    The regime is chosen by token divisibility, as in JAX.  ``params``
    and ``x`` are DTensors on ``mesh`` or plain tensors, taken as
    replicated; the result is of ``x``'s kind (a plain ``x`` gets the
    whole ``y``).  Each rank runs JAX's ``local_moe`` on its local
    shards; the collectives are ``torch.distributed._functional_collectives``
    on the groups of the mesh's dims; the local expert FFN is
    :func:`expert_ffn`, three ``branch_matmul`` launches.  ``stats``, a
    dict, receives the ``regime`` and this rank's ``dropped`` (token,
    choice) pairs.

    One difference from JAX, in the a2a regime: JAX writes the metadata
    of every dropped pair (-1) to send slot (0, 0) with a scatter-set,
    so when a rank drops a pair after the one it keeps in that slot, JAX
    loses that kept pair too.  The port drops only the pairs over
    capacity (Switch semantics); the outputs differ at exactly those
    tokens (``tests/test_torch_distributed.py``).
    """
    from repro_torch.utils.sharding import axis_sizes

    sizes = axis_sizes(mesh)
    n_shards = sizes[axis]
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != axis)
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    T = x.shape[0]
    if T % (n_shards * n_data) == 0 and T // (n_shards * n_data) >= 8:
        fn = _moe_ep_a2a
    else:
        fn = _moe_ep_replicated
    if stats is not None:
        stats["regime"] = "a2a" if fn is _moe_ep_a2a else "replicated"
    y, aux = fn(params, cfg, x, mesh, axis, data_axes, stats)
    if params.shared is not None:
        y = y + mlp(params.shared, x)
    return y, aux


def _from_local(y, spec, mesh, like):
    """The output side of ``shard_map``: the local results placed as
    ``like`` (the tokens) was — for the a2a regime's tokens split over
    every axis, a gather over the axes ``like`` did not split, since
    DTensor misplaces the (B, S, d) view of a token dim split over two
    mesh dims — or, for a plain ``like``, the whole tensor."""
    from torch.distributed.tensor import DTensor

    out = from_local(y, spec, mesh)
    if isinstance(like, DTensor):
        return out.redistribute(mesh, like.placements)
    return out.full_tensor()


def _all_to_all(t, mesh, axis):
    """Row block i of ``t`` (n, ...) to rank i of ``axis``; row block i of
    the result came from rank i (JAX's untiled ``all_to_all`` on dim 0)."""
    from torch.distributed import _functional_collectives as funcol

    group = (mesh, list(mesh.mesh_dim_names).index(axis))
    flat = t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])
    out = funcol.all_to_all_single_autograd(flat.contiguous(), None, None,
                                            group)
    return funcol.wait_tensor(out).reshape(t.shape)


def _capacity(counts, bound: int, even: int) -> int:
    """Bucket rows for the local expert FFN, dropless: the largest count
    rounded up to :data:`CAPACITY_STEP`, at most ``bound`` (at most
    ``bound`` rows can reach one expert).  Tensors with no values (the
    dry-run's fake tensors) have no routing to read: they take ``even``,
    an expert's rows under an even routing, rounded the same way, so the
    dry-run models an even load (real routings run above it)."""
    from torch._subclasses.fake_tensor import is_fake

    if bound <= CAPACITY_STEP:
        return bound
    top = even if is_fake(counts) else int(counts.max())
    return min(bound, -(-top // CAPACITY_STEP) * CAPACITY_STEP)


def _local_ffn(w_gate, w_up, w_down, rows, e_loc, E_local, bound, even):
    """JAX's sorted ``ragged_dot`` FFN over ``rows`` (R, d), each row going
    to local expert ``e_loc`` (R,) (E_local: no expert, output zero):
    the rows bucketed by expert and three ``branch_matmul`` launches with
    the experts' counts (capacity: :func:`_capacity`).  Returns (R, d)."""
    counts = (e_loc[:, None] == torch.arange(E_local, device=e_loc.device)
              ).sum(0)
    b = Buckets(e_loc[:, None], E_local + 1,
                cap=_capacity(counts, bound, even))
    xb = torch.where(b.valid[:E_local, :, None], rows[b.src[:E_local]],
                     rows.new_zeros(()))
    yb = expert_ffn(SimpleNamespace(w_gate=w_gate, w_up=w_up,
                                    w_down=w_down), xb, counts.int())
    valid = e_loc < E_local
    out = yb[e_loc.clamp(max=E_local - 1), b.pos[:, 0].clamp(max=b.cap - 1)]
    return torch.where(valid[:, None], out, out.new_zeros(()))


def _moe_ep_replicated(params: MoE, cfg, x, mesh, axis, data_axes, stats):
    """Decode-regime EP with 2-D expert sharding (§Perf O2').

    Tokens are replicated over the whole mesh; expert weights stay
    sharded at rest — expert dim over ``axis``, FFN hidden dim over the
    data axes when they divide it — so no weight moves.  Every rank
    computes its experts' share of its FFN slice; the partial outputs
    are summed over both axes.  Dropless."""
    from repro_torch.utils.sharding import P, axis_sizes

    m = cfg.moe
    sizes = axis_sizes(mesh)
    n_shards = sizes[axis]
    E_local = m.num_experts // n_shards
    if E_local * n_shards != m.num_experts:
        raise ValueError(f"{m.num_experts} experts not divisible by "
                         f"{axis}={n_shards}")
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    f_sharded = bool(data_axes) and m.d_ff_expert % n_data == 0
    fe = (data_axes if len(data_axes) > 1 else data_axes[0]) \
        if f_sharded else None
    router = to_local(params.router, P(None, None), mesh)
    w_gate = to_local(params.w_gate, P(axis, None, fe), mesh)
    w_up = to_local(params.w_up, P(axis, None, fe), mesh)
    w_down = to_local(params.w_down, P(axis, fe, None), mesh)
    x_loc = to_local(x, P(None, None), mesh)

    T_loc = x_loc.shape[0]
    k = m.num_experts_per_tok
    w, idx, aux = route(SimpleNamespace(router=router), cfg, x_loc)
    shard = mesh.get_local_rank(axis)
    flat_e = idx.reshape(-1)
    mine = (flat_e // E_local) == shard
    e_loc = torch.where(mine, flat_e % E_local, E_local)   # overflow grp
    tok = torch.arange(T_loc * k, device=x_loc.device) // k
    ys = _local_ffn(w_gate, w_up, w_down, x_loc[tok], e_loc, E_local,
                    T_loc, -(-T_loc * k // m.num_experts))
    y = _combine(ys.reshape(T_loc, k, -1), w, x_loc.dtype)
    # partial over f (data axes) + masked over experts (model axis)
    y = psum(y, mesh, (axis,) + (data_axes if f_sharded else ()))
    if stats is not None:
        stats["dropped"] = torch.zeros((), dtype=torch.int64,
                                       device=x_loc.device)
    return _from_local(y, P(None, None), mesh, x), aux


def _moe_ep_a2a(params: MoE, cfg, x, mesh, axis, data_axes, stats):
    """Train/prefill-regime EP: capacity-based all-to-all dispatch.

    Experts are sharded over ``axis``; each rank routes its own tokens
    (split over every mesh axis), fills one buffer of ``kcap`` rows per
    destination rank in the order the (token, choice) pairs appear
    (JAX's cumsum rule), and exchanges them.  Pairs over capacity drop
    and contribute zero — Switch semantics.  Returns (y sharded like the
    tokens, aux averaged over every rank)."""
    from repro_torch.utils.sharding import P, axis_sizes

    m = cfg.moe
    sizes = axis_sizes(mesh)
    n_shards = sizes[axis]
    E_local = m.num_experts // n_shards
    if E_local * n_shards != m.num_experts:
        raise ValueError(f"{m.num_experts} experts not divisible by "
                         f"{axis}={n_shards}")
    tok_spec = P((*data_axes, axis))
    router = to_local(params.router, P(None, None), mesh)
    w_gate = to_local(params.w_gate, P(axis, None, None), mesh)
    w_up = to_local(params.w_up, P(axis, None, None), mesh)
    w_down = to_local(params.w_down, P(axis, None, None), mesh)
    x_loc = to_local(x, P(tok_spec[0], None), mesh)

    T_loc, d = x_loc.shape
    k = m.num_experts_per_tok
    w, idx, aux = route(SimpleNamespace(router=router), cfg, x_loc)
    kcap = int(max(1, T_loc * k * m.capacity_factor // n_shards))

    # --- per-destination send buffers, by the pairs' order of appearance
    send = Buckets(idx // E_local, n_shards, cap=kcap)
    meta = torch.stack([(idx % E_local).float(), w.float()], -1)
    meta = meta.reshape(T_loc * k, 2)[send.pair]         # (n, kcap, 2)
    send_meta = torch.where(send.valid[..., None], meta, -1.0)
    send_x = send.gather(x_loc)                           # (n, kcap, d)

    # --- exchange: rank i sends row block j to rank j
    rx = _all_to_all(send_x, mesh, axis).reshape(n_shards * kcap, d)
    recv_meta = _all_to_all(send_meta, mesh, axis).reshape(-1, 2)
    re = recv_meta[:, 0].long()
    re = torch.where(re >= 0, re, E_local)               # overflow bucket

    # --- local grouped expert FFN; a source row meets an expert once
    ys = _local_ffn(w_gate, w_up, w_down, rx, re, E_local,
                    min(n_shards * kcap, n_shards * T_loc),
                    -(-T_loc * k // E_local))
    back = _all_to_all(ys.reshape(n_shards, kcap, d), mesh, axis)

    # --- return to source ranks and combine
    y = send.combine(back, w, x_loc.dtype)
    aux = psum(aux, mesh, data_axes + (axis,)) / mesh.size()
    if stats is not None:
        stats["dropped"] = (~send.keep).sum()
    return _from_local(y, tok_spec + (None,), mesh, x), aux


def _combine(rows, w, dtype):
    """rows (T, k, d) weighted by gates w (T, k), added in choice order."""
    y = torch.zeros(rows.shape[0], rows.shape[2], dtype=dtype,
                    device=rows.device)
    contrib = rows * w[..., None]
    for j in range(rows.shape[1]):
        y = y + contrib[:, j]
    return y
