"""Hand-built graphs for the PyTorch port: the twin of ``graph_zoo.py``.

The same six builders with the same topology, node names, shapes, flops
and ``supported`` flags, and the same ``make_inputs(rng)`` numpy
environments, so both packages get identical inputs.  Node fns are
PyTorch; a pure matmul is written ``a @ w``.  Control flow stays on the
device: ``torch.where`` on a reduced predicate instead of ``lax.cond``,
and a fixed ``max_iters`` loop whose state freezes once the condition
fails instead of ``lax.while_loop`` (equal, because a state that fails
the test never changes again).  No node calls ``.item()``: that would
synchronise the host in the middle of a single-sync run.

Each builder returns ``(graph, make_inputs)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import GraphBuilder, TensorSpec, matmul_flops


def _mm_spec(m, n):
    return TensorSpec((m, n), "float32")


def chain_graph(depth=5, dim=8):
    """input -> matmul x depth -> output: one branch, no parallelism."""
    b = GraphBuilder()
    x = b.input((dim, dim), name="x")
    ws = []
    cur = x
    for i in range(depth):
        w = b.param((dim, dim), name=f"w{i}")
        ws.append(w)
        cur = b.op(f"mm{i}", "matmul", [cur, w], [_mm_spec(dim, dim)],
                   flops=matmul_flops(dim, dim, dim),
                   fn=lambda a, w: a @ w)
    b.mark_output(cur)
    g = b.build()

    def make_inputs(rng):
        env = {x: rng.standard_normal((dim, dim), dtype=np.float32)}
        for w in ws:
            env[w] = rng.standard_normal((dim, dim), dtype=np.float32)
        return env

    return g, make_inputs


def diamond_graph(dim=8, branch_len=3, width=2):
    """splitter -> `width` parallel chains of len `branch_len` -> merger."""
    b = GraphBuilder()
    x = b.input((dim, dim), name="x")
    params = []
    split = b.op("split", "elementwise", [x], [_mm_spec(dim, dim)],
                 flops=dim * dim, fn=lambda a: a * 2.0)
    tails = []
    for w_i in range(width):
        cur = split
        for d in range(branch_len):
            w = b.param((dim, dim), name=f"w{w_i}_{d}")
            params.append(w)
            cur = b.op(f"br{w_i}_mm{d}", "matmul", [cur, w],
                       [_mm_spec(dim, dim)],
                       flops=matmul_flops(dim, dim, dim),
                       fn=lambda a, w: torch.tanh(a @ w))
        tails.append(cur)
    merged = b.op("merge", "elementwise", tails, [_mm_spec(dim, dim)],
                  flops=dim * dim * width,
                  fn=lambda *ts: sum(ts))
    b.mark_output(merged)
    g = b.build()

    def make_inputs(rng):
        env = {x: rng.standard_normal((dim, dim), dtype=np.float32)}
        for p in params:
            env[p] = (rng.standard_normal((dim, dim), dtype=np.float32)
                      * 0.3)
        return env

    return g, make_inputs


def heterogeneous_graph(dim=16):
    """Mixed supported/unsupported ops: two big matmul regions separated by
    a control-flow (fallback) op, plus a small misc tail — exercises the
    delegate cost model and fallback handling."""
    b = GraphBuilder()
    x = b.input((dim, dim), name="x")
    params = []

    def mm_chain(cur, count, tag):
        for i in range(count):
            w = b.param((dim, dim), name=f"{tag}_w{i}")
            params.append(w)
            cur = b.op(f"{tag}_mm{i}", "matmul", [cur, w],
                       [_mm_spec(dim, dim)],
                       flops=2e9,  # force F over the delegation floor
                       fn=lambda a, w: (a @ w) * 0.1)
        return cur

    r1 = mm_chain(x, 4, "regA")
    # dynamic control-flow op: unsupported -> CPU fallback
    cf = b.op("dyn_if", "control_flow", [r1], [_mm_spec(dim, dim)],
              flops=0.0, supported=False,
              fn=lambda a: torch.where(a.sum() > 0, a, -a))
    r2 = mm_chain(cf, 4, "regB")
    # second fallback then a *small* supported region: rejected by the cost
    # model (N=2 < 3, F << 1e9) -> stays on CPU ("trims small segments")
    cf2 = b.op("dyn_while", "control_flow", [r2], [_mm_spec(dim, dim)],
               flops=0.0, supported=False,
               fn=lambda a: torch.where(a.mean() > 0, a, a * 0.5))
    wsmall = b.param((dim, dim), name="w_small")
    params.append(wsmall)
    tiny = b.op("tiny_mm", "matmul", [cf2, wsmall], [_mm_spec(dim, dim)],
                flops=matmul_flops(dim, dim, dim),
                fn=lambda a, w: a @ w)
    small = b.op("reshape", "misc", [tiny], [TensorSpec((dim * dim,),
                                                        "float32")],
                 flops=0.0, fn=lambda a: a.reshape(-1))
    b.mark_output(small)
    g = b.build()

    def make_inputs(rng):
        env = {x: rng.standard_normal((dim, dim), dtype=np.float32)}
        for p in params:
            env[p] = rng.standard_normal((dim, dim), dtype=np.float32) * 0.2
        return env

    return g, make_inputs


def multihead_graph(dim=16, heads=4, seq=8):
    """Transformer-attention shaped: shared input -> per-head chains
    (qkv proj -> attention core -> per-head out proj) -> residual merge.
    The canonical source of branch parallelism Parallax exploits; each
    head branch has N=3 nodes so it clears the paper's N>2 floor."""
    b = GraphBuilder()
    x = b.input((seq, dim), name="x")
    params = []
    head_dim = dim // heads
    outs = []

    def attn_core(qkv):
        q, k, v = torch.split(qkv, head_dim, dim=-1)
        s = (q @ k.T) / float(np.sqrt(head_dim))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        return p @ v

    for h in range(heads):
        w_qkv = b.param((dim, 3 * head_dim), name=f"wqkv{h}")
        w_o = b.param((head_dim, dim), name=f"wo{h}")
        params += [w_qkv, w_o]
        qkv = b.op(f"h{h}_qkv", "matmul", [x, w_qkv],
                   [TensorSpec((seq, 3 * head_dim))],
                   flops=matmul_flops(seq, 3 * head_dim, dim),
                   fn=lambda a, w: a @ w)
        core = b.op(f"h{h}_attn", "elementwise", [qkv],
                    [TensorSpec((seq, head_dim))],
                    flops=2 * matmul_flops(seq, seq, head_dim),
                    fn=attn_core)
        o = b.op(f"h{h}_proj", "matmul", [core, w_o],
                 [TensorSpec((seq, dim))],
                 flops=matmul_flops(seq, dim, head_dim),
                 fn=lambda a, w: a @ w)
        outs.append(o)
    y = b.op("head_merge", "elementwise", outs, [TensorSpec((seq, dim))],
             flops=seq * dim * heads, fn=lambda *hs: sum(hs))
    b.mark_output(y)
    g = b.build()

    def make_inputs(rng):
        env = {x: rng.standard_normal((seq, dim), dtype=np.float32)}
        for p in params:
            env[p] = rng.standard_normal(
                tuple(g.tensors[p].spec.static_shape),
                dtype=np.float32) * 0.3
        return env

    return g, make_inputs


def cond_graph(dim=8, branch_len=3, width=2, tail_len=3):
    """Parallel matmul branches feeding a data-dependent gate.

    The control-flow node picks its branch at run time (§3.4: forced
    Split-Merge, unsupported -> host fallback), then a supported matmul
    tail resumes — an accel -> host -> accel round trip for the
    heterogeneous runtime.  Both sides are computed and ``torch.where``
    keeps one, so the predicate never leaves the device."""
    b = GraphBuilder()
    x = b.input((dim, dim), name="x")
    params = []
    split = b.op("split", "elementwise", [x], [_mm_spec(dim, dim)],
                 flops=dim * dim, fn=lambda a: a * 0.5 + 0.1)
    tails = []
    for w_i in range(width):
        cur = split
        for d in range(branch_len):
            w = b.param((dim, dim), name=f"cw{w_i}_{d}")
            params.append(w)
            cur = b.op(f"c{w_i}_mm{d}", "matmul", [cur, w],
                       [_mm_spec(dim, dim)],
                       flops=matmul_flops(dim, dim, dim),
                       fn=lambda a, w: torch.tanh(a @ w))
        tails.append(cur)
    merged = b.op("merge", "elementwise", tails, [_mm_spec(dim, dim)],
                  flops=dim * dim * width, fn=lambda *ts: sum(ts))
    gate = b.op("cond_gate", "control_flow", [merged], [_mm_spec(dim, dim)],
                flops=0.0, supported=False,
                fn=lambda a: torch.where(a.sum() > 0, a * 1.5 + 1.0,
                                         -a * 0.5))
    cur = gate
    for d in range(tail_len):
        w = b.param((dim, dim), name=f"ct_{d}")
        params.append(w)
        cur = b.op(f"tail_mm{d}", "matmul", [cur, w], [_mm_spec(dim, dim)],
                   flops=matmul_flops(dim, dim, dim),
                   fn=lambda a, w: (a @ w) * 0.1)
    b.mark_output(cur)
    g = b.build()

    def make_inputs(rng):
        env = {x: rng.standard_normal((dim, dim), dtype=np.float32)}
        for p in params:
            env[p] = rng.standard_normal((dim, dim), dtype=np.float32) * 0.3
        return env

    return g, make_inputs


def while_graph(dim=8, depth=3, max_iters=6):
    """Matmul chain -> bounded while-loop fallback -> matmul chain.

    The loop's trip count is data-dependent but bounded by ``max_iters``
    (§3.2 dynamic-shape discipline applied to control flow): classified
    Split-Merge.  It runs ``max_iters`` steps with the state frozen by
    ``torch.where`` once the condition fails."""
    b = GraphBuilder()
    x = b.input((dim, dim), name="x")
    params = []

    def mm_chain(cur, tag):
        for i in range(depth):
            w = b.param((dim, dim), name=f"{tag}_w{i}")
            params.append(w)
            cur = b.op(f"{tag}_mm{i}", "matmul", [cur, w],
                       [_mm_spec(dim, dim)],
                       flops=matmul_flops(dim, dim, dim),
                       fn=lambda a, w: (a @ w) * 0.2)
        return cur

    head = mm_chain(x, "pre")

    def bounded_while(a, _n=max_iters):
        for _ in range(_n):
            a = torch.where(torch.abs(a).sum() > 1e-3, a * 0.5 + 0.01, a)
        return a

    loop = b.op("bounded_while", "control_flow", [head],
                [_mm_spec(dim, dim)], flops=0.0, supported=False,
                fn=bounded_while)
    tail = mm_chain(loop, "post")
    b.mark_output(tail)
    g = b.build()

    def make_inputs(rng):
        env = {x: rng.standard_normal((dim, dim), dtype=np.float32)}
        for p in params:
            env[p] = rng.standard_normal((dim, dim), dtype=np.float32) * 0.4
        return env

    return g, make_inputs


ALL_ZOO = {
    "chain": chain_graph,
    "cond": cond_graph,
    "diamond": diamond_graph,
    "heterogeneous": heterogeneous_graph,
    "multihead": multihead_graph,
    "while": while_graph,
}
