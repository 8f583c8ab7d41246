"""The plain fp32 reference of the benchmark's decoders.

Plain PyTorch, TF32 off: token embedding, RMSNorm, attention with RoPE
and grouped K/V heads under a causal softmax (queries in blocks, so
S x S scores never exist whole), the top-k MoE router in fp32 with its
renormalised gates and every expert's SwiGLU on the rows routed to it,
a dense SwiGLU, and the Mamba2 mixer (input projection, depthwise causal
conv, the SSD recurrence computed chunk by chunk with the state carried
between chunks, ``+ D x``, the gated RMSNorm, output projection); the
final norm and the LM head at the positions asked for.

It imports nothing of the program.  The weights are drawn again from the
seed (:mod:`stack`), one layer at a time, in the served dtype, and
widened to fp32 when first read.  ``quant="fp8"`` is the control: every
served-dtype weight matrix rounded to float8 e4m3 with one scale per
output channel before use (activations stay fp32).  ``quant="bf16"`` is
the witness of bf16 rounding alone: the residual stream after every
block and every norm's output rounded to bf16, as the served model
holds them (weights as served, arithmetic in fp32).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

import stack

ATTN_BLOCK = 1024        # query rows a block of the causal softmax


@contextlib.contextmanager
def full_fp32():
    """Matmuls in true fp32 (no TF32) while the reference runs."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def fp8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` rounded to float8 e4m3, one absmax scale along ``dim``."""
    s = w.abs().amax(dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Weights:
    """One stream's leaves, widened to fp32 (and rounded, for the
    control) when first read."""

    def __init__(self, raw: dict, leaves, quant: "str | None"):
        self.raw, self.quant, self.wide = raw, quant, {}
        self.served = {lf.path for lf in leaves if not lf.fp32}

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the variant holds it between operations."""
        if self.quant == "bf16":
            return x.bfloat16().float()
        return x

    def __call__(self, path: str, dim: int = -2) -> torch.Tensor:
        w = self.wide.get(path)
        if w is None:
            w = self.raw.pop(path).float()
            if self.quant == "fp8" and path in self.served and w.ndim >= 2:
                w = fp8(w, dim)
            self.wide[path] = w
        return w


def rms_norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (S, h, D): rotate the two halves by position * theta^(-2j/D)."""
    S, _, D = x.shape
    j = torch.arange(0, D, 2, dtype=torch.float64, device=x.device)
    inv = 1.0 / theta ** (j / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(dm, w: Weights, x):
    S = x.shape[0]
    H, K, D = dm.H, dm.K, dm.D
    G = H // K
    q = rope((x @ w("attn.wq")).view(S, H, D), dm.theta)
    k = rope((x @ w("attn.wk")).view(S, K, D), dm.theta)
    v = (x @ w("attn.wv")).view(S, K, D)
    out = torch.empty(S, H, D, device=x.device)
    for q0 in range(0, S, ATTN_BLOCK):
        q1 = min(S, q0 + ATTN_BLOCK)
        qb = q[q0:q1].view(q1 - q0, K, G, D)
        s = torch.einsum("qkgd,tkd->kgqt", qb, k[:q1]) / math.sqrt(D)
        qi = torch.arange(q0, q1, device=x.device)[:, None]
        ti = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(ti > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[q0:q1] = torch.einsum("kgqt,tkd->qkgd", p, v[:q1]) \
            .reshape(q1 - q0, H, D)
    return out.reshape(S, H * D) @ w("attn.wo")


def moe(dm, w: Weights, x, margins=None):
    logits = x @ w("moe.router")
    if margins is not None:        # router logit gap, choice k to k + 1
        top = torch.topk(logits, min(dm.k + 1, dm.E), dim=-1).values
        margins.append(top[:, dm.k - 1] - top[:, -1])
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, dm.k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    wg, wu, wd = w("moe.w_gate"), w("moe.w_up"), w("moe.w_down")
    for e in range(dm.E):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        ye = (F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e]
        y.index_add_(0, rows, ye * gate[rows, slot, None])
    return y


def dense(dm, w: Weights, x):
    return (F.silu(x @ w("mlp.w_gate")) * (x @ w("mlp.w_up"))) \
        @ w("mlp.w_down")


def ssd(dm, x, dt, A, B, C):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, chunk by chunk.  x (S, H, P), dt (S, H), B and C (S,
    G, N); head h reads group h // (H / G)."""
    S, H, P = x.shape
    rep = H // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1)              # (S, H, N)
    Ch = C.repeat_interleave(rep, dim=1)
    state = torch.zeros(H, P, B.shape[2], device=x.device)
    y = torch.empty_like(x)
    L = dm.chunk
    for c0 in range(0, S, L):
        c1 = min(S, c0 + L)
        a = torch.cumsum(dt[c0:c1] * A, dim=0)         # (l, H)
        seg = a[:, None, :] - a[None, :, :]            # (i, j, H)
        i = torch.arange(c1 - c0, device=x.device)
        seg = seg.masked_fill((i[None, :] > i[:, None])[..., None],
                              float("-inf"))
        cb = torch.einsum("ihn,jhn->ijh", Ch[c0:c1], Bh[c0:c1])
        xdt = x[c0:c1] * dt[c0:c1, :, None]           # (l, H, P)
        y[c0:c1] = torch.einsum("ijh,jhp->ihp", cb * torch.exp(seg), xdt) \
            + torch.einsum("ihn,hpn->ihp", Ch[c0:c1], state) \
            * torch.exp(a)[..., None]
        tail = torch.exp(a[-1][None, :] - a)          # (l, H)
        state = torch.exp(a[-1])[:, None, None] * state \
            + torch.einsum("jh,jhp,jhn->hpn", tail, xdt, Bh[c0:c1])
    return y


def mamba(dm, w: Weights, x):
    S = x.shape[0]
    zxbcdt = x @ w("mamba.in_proj")
    z, xBC, dt = torch.split(zxbcdt, [dm.di, dm.conv_dim, dm.Hm], dim=-1)
    cw = w("mamba.conv_w")                            # (Kw, conv_dim)
    pad = F.pad(xBC, (0, 0, dm.Kw - 1, 0))
    conv = sum(pad[i:i + S] * cw[i] for i in range(dm.Kw))
    xBC = F.silu(conv + w("mamba.conv_b"))
    gN = dm.G * dm.N
    xs, B, C = torch.split(xBC, [dm.di, gN, gN], dim=-1)
    xs = xs.reshape(S, dm.Hm, dm.P)
    dt = F.softplus(dt + w("mamba.dt_bias"))
    A = -torch.exp(w("mamba.A_log"))
    y = ssd(dm, xs, dt, A, B.reshape(S, dm.G, dm.N),
            C.reshape(S, dm.G, dm.N))
    y = (y + w("mamba.D")[:, None] * xs).reshape(S, dm.di)
    y = rms_norm(y * F.silu(z), w("mamba.norm_scale"))
    return y @ w("mamba.out_proj")


def block(dm, w: Weights, mixer: str, channel: str, x, margins=None):
    h = w.act(rms_norm(x, w("norm1.scale")))
    x = w.act(x + (attention(dm, w, h) if mixer == "attn"
                   else mamba(dm, w, h)))
    if channel == "none":
        return x
    h = w.act(rms_norm(x, w("norm2.scale")))
    return w.act(x + (moe(dm, w, h, margins) if channel == "moe"
                      else dense(dm, w, h)))


@torch.no_grad()
def logits(run: dict, seed: int, seqs: "list[torch.Tensor]",
           positions: "list[torch.Tensor]", device,
           quant: "str | None" = None,
           margins: "list | None" = None) -> "list[torch.Tensor]":
    """fp32 logits (n_i, V) of sequence i at ``positions[i]``: each
    sequence (1-D token ids) runs whole through every layer, layer by
    layer, with that layer's weights drawn again from ``seed``.  Given a
    list, ``margins`` receives for each sequence the smallest router
    logit gap between the k-th and the next expert over the MoE layers,
    at each of its positions (the look at near-tied routing)."""
    dm = stack.Dims(run)
    with full_fp32():
        g = Weights(stack.globals_of(dm, seed, device),
                    stack.global_leaves(dm), quant)
        table = g("embed", dim=-1)
        hs = [table[s.to(device).long()] for s in seqs]
        del table
        gaps = [[] if margins is not None else None for _ in seqs]
        for i, (mixer, channel) in enumerate(dm.plan()):
            w = Weights(stack.layer_of(dm, seed, i, device),
                        stack.layer_leaves(dm, i), quant)
            hs = [block(dm, w, mixer, channel, h, m)
                  for h, m in zip(hs, gaps)]
            del w
        if margins is not None:
            margins += [torch.stack(m).amin(0)[p.to(device).long()].cpu()
                        if m else None for m, p in zip(gaps, positions)]
        head = g("lm_head")
        scale = g("final_norm.scale")
        return [g.act(rms_norm(h[p.to(device).long()], scale)) @ head
                for h, p in zip(hs, positions)]
