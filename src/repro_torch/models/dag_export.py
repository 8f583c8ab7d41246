"""Model -> Parallax DAG exporter (the decoder half).

Port of ``repro.models.dag_export``: builds a :class:`~repro_torch.core.
graph.Graph` for a decoder :class:`~repro_torch.models.transformer.LM`
at a given (batch, seq), with executable node fns closing over its
weights — so the paper's pipeline (partition / branch / arena / schedule)
and :class:`~repro_torch.core.PlanExecutor` run against the actual
architecture, not toy graphs.

Granularity mirrors what a mobile-framework graph looks like after
conversion (the paper's "Pre" graphs): per-KV-group attention chains,
elementwise/norm nodes, and RoPE marked unsupported -> CPU fallback.

Node fns compute in fp32 on their input's device: an fp32 LM's weights
are held as they lie (per-group slices are views, so nothing is copied);
any other dtype is converted to fp32 once.  Every constant a node fn
reads (weights, positions, masks) goes through :class:`_PerDevice`: a
node the heterogeneous runtime places on the host reads host copies of
its weights, made at its first run and kept, so weights sit on their
consumer's device, as ``hetero/transfer.py`` accounts for them.  As in
the JAX exporter, the QKV biases of the Qwen2 family are not exported.  A Mamba2
mixer is a 4-node chain whose SSD scan node is marked unsupported (the
paper's "unsupported kernel" fallback class) and runs the ``ssd_scan``
kernel.  An MoE channel is a router node marked unsupported (data-
dependent top-k dispatch), E parallel two-node expert chains (the §3.1
β-balanced branches) and a combine.  The Whisper encoder arrives with
its slice.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import GraphBuilder, TensorSpec, matmul_flops
from repro_torch.core.flops import (attention_flops, elementwise_flops,
                                    ssd_scan_flops)
from repro_torch.kernels.ssd_scan import ssd_scan

from .common import apply_rope, layer_norm, rms_norm
from .ssm import _causal_conv, _dims, _gated_norm, _split_proj, _ssm_inputs


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float()


class _PerDevice:
    """A node fn's constant, held once per device: the tensor on its own
    device, and a copy on any other device a node reads it on, made at
    the first read and kept.  ``shape`` and ``dtype`` are the tensor's,
    so fn fingerprints see it as they see a tensor."""

    def __init__(self, t: torch.Tensor):
        self._copies = {t.device: t}
        self.shape, self.dtype = t.shape, t.dtype

    def on(self, x: torch.Tensor) -> torch.Tensor:
        """The constant on ``x``'s device."""
        c = self._copies.get(x.device)
        if c is None:
            c = next(iter(self._copies.values())).to(x.device)
            self._copies[x.device] = c
        return c


def export_decoder_graph(cfg, params, batch: int, seq: int,
                         flops_cfg=None):
    """Decoder-only LM -> (graph, make_inputs).

    ``params`` is the port's :class:`~repro_torch.models.transformer.LM`
    on the same config (from ``build_model(cfg).init`` or the params
    bridge).  The graph covers embed -> blocks (attention KV groups as
    parallel branches) -> final norm -> lm_head.

    ``flops_cfg``: when the graph is built from a width-shrunk
    ``structural()`` config, pass the FULL config here — node FLOP
    metadata (which drives the §3.1 delegation cost model and balance
    refinement) is then computed at full-model scale while the
    executable fns keep the small weights.

    ``make_inputs(rng)`` draws the tokens with numpy (the JAX exporter's
    draw) and returns the embedding and head as fp32 tensors on the LM's
    device.
    """
    from .blocks import block_pattern

    fc = flops_cfg or cfg
    pattern = block_pattern(cfg)
    b = GraphBuilder()
    d = cfg.d_model
    S, B = seq, batch
    device = params.embed.device

    tokens = b.input((B, S), "int32", name="tokens")
    embed_t = b.param((cfg.vocab_size, d), name="embed")

    x = b.op("embed", "misc", [tokens, embed_t], [TensorSpec((B, S, d))],
             flops=0.0, fn=lambda t, e: e[t.long()])

    positions = torch.arange(S, device=device)[None, :]

    for i in range(cfg.num_layers):
        x = _export_block(b, cfg, params.layers[i], x, pattern[i], i, B, S,
                          positions, fc)

    x = _norm_node(b, cfg, params.final_norm, x, "final_norm", B, S,
                   fc.d_model)
    head_flops = matmul_flops(S, fc.vocab_size, fc.d_model, B)
    if cfg.tie_embeddings:
        logits = b.op("lm_head", "matmul", [x, embed_t],
                      [TensorSpec((B, S, cfg.vocab_size))],
                      flops=head_flops, fn=lambda h, e: h @ e.T)
    else:
        head_t = b.param((d, cfg.vocab_size), name="lm_head")
        logits = b.op("lm_head", "matmul", [x, head_t],
                      [TensorSpec((B, S, cfg.vocab_size))],
                      flops=head_flops, fn=lambda h, w: h @ w)
    b.mark_output(logits)
    g = b.build()

    def make_inputs(rng):
        env = {tokens: rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        env[embed_t] = _f32(params.embed)
        if not cfg.tie_embeddings:
            env[head_t] = _f32(params.lm_head)
        return env

    return g, make_inputs


def _norm_node(b, cfg, norm_params, x, name, B, S, d_flops=None):
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        def fn(h, s=_PerDevice(_f32(norm_params.scale))):
            return rms_norm(s.on(h), h)
    else:
        def fn(h, s=_PerDevice(_f32(norm_params.scale)),
               b=_PerDevice(_f32(norm_params.bias))):
            return layer_norm(SimpleNamespace(scale=s.on(h), bias=b.on(h)),
                              h)
    return b.op(name, "elementwise", [x], [TensorSpec((B, S, d))],
                flops=elementwise_flops(B * S * (d_flops or d)), fn=fn)


def _export_block(b, cfg, bp, x, kind, layer_i, B, S, positions, fc=None):
    fc = fc or cfg
    mixer, channel = kind
    d = cfg.d_model
    dF = fc.d_model
    h_in = _norm_node(b, cfg, bp.norm1, x, f"L{layer_i}.norm1", B, S)

    if mixer == "attn":
        y = _export_attention(b, cfg, bp.attn, h_in, layer_i, B, S,
                              positions, fc)
    else:
        y = _export_mamba(b, cfg, bp.mamba, h_in, layer_i, B, S, fc)

    x = b.op(f"L{layer_i}.residual1", "elementwise", [x, y],
             [TensorSpec((B, S, d))], flops=elementwise_flops(B * S * dF),
             fn=lambda a, c: a + c)

    if channel == "none":
        return x
    h2 = _norm_node(b, cfg, bp.norm2, x, f"L{layer_i}.norm2", B, S)
    if channel == "dense":
        y2 = _export_mlp(b, cfg, bp.mlp, h2, layer_i, B, S, fc)
    else:
        y2 = _export_moe(b, cfg, bp.moe, h2, layer_i, B, S, fc)
    return b.op(f"L{layer_i}.residual2", "elementwise", [x, y2],
                [TensorSpec((B, S, d))],
                flops=elementwise_flops(B * S * dF), fn=lambda a, c: a + c)


def _export_attention(b, cfg, ap, h, layer_i, B, S, positions, fc=None):
    """Per-KV-group 4-node chains:

        qkv proj (matmul) -> RoPE (unsupported, CPU fallback) ->
        attention core (elementwise) -> out proj (matmul)

    A GQA group (one kv head + its query heads) is the natural branch
    unit — chains clear the paper's N > 2 floor and are β-balanced by
    construction.  RoPE's data-dependent position gather is the
    realistic per-layer *unsupported* op (dynamic-shape class, paper §1)
    that fragments delegate regions inside every attention layer."""
    fc = fc or cfg
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    hdF = fc.resolved_head_dim()
    dF = fc.d_model
    H, K = cfg.num_heads, cfg.num_kv_heads
    G = H // K
    window = cfg.sliding_window
    inv_freq = _PerDevice(ap.inv_freq)
    scale = float(np.sqrt(hd))
    wq = _f32(ap.wq).view(d, H, hd)
    wk = _f32(ap.wk).view(d, K, hd)
    wv = _f32(ap.wv).view(d, K, hd)
    wo = _f32(ap.wo).view(H, hd, d)
    qpos = positions[0][:, None]
    kpos = positions[0][None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    positions, mask = _PerDevice(positions), _PerDevice(mask)
    outs = []
    for g in range(K):
        wq_g = _PerDevice(wq[:, g * G:(g + 1) * G, :].reshape(d, G * hd))
        wk_g, wv_g = _PerDevice(wk[:, g, :]), _PerDevice(wv[:, g, :])
        wo_g = _PerDevice(wo[g * G:(g + 1) * G].reshape(G * hd, d))

        def qkv_fn(hh, wq_=wq_g, wk_=wk_g, wv_=wv_g):
            return torch.cat([hh @ wq_.on(hh), hh @ wk_.on(hh),
                              hh @ wv_.on(hh)], dim=-1)

        qkv = b.op(f"L{layer_i}.g{g}.qkv", "matmul", [h],
                   [TensorSpec((B, S, (G + 2) * hd))],
                   flops=matmul_flops(S, (G + 2) * hdF, dF, B),
                   fn=qkv_fn)

        def rope_fn(qkv_, G_=G):
            q, k, v = torch.split(qkv_, [G_ * hd, hd, hd], dim=-1)
            pos, freq = positions.on(qkv_), inv_freq.on(qkv_)
            q = apply_rope(q.reshape(B, S, G_, hd), pos,
                           freq).reshape(B, S, G_ * hd)
            k = apply_rope(k.reshape(B, S, 1, hd), pos,
                           freq).reshape(B, S, hd)
            return torch.cat([q, k, v], dim=-1)

        roped = b.op(f"L{layer_i}.g{g}.rope", "elementwise", [qkv],
                     [TensorSpec((B, S, (G + 2) * hd))],
                     flops=elementwise_flops(B * S * (G + 1) * hdF),
                     supported=False, fn=rope_fn)

        def attn_fn(qkv_, G_=G):
            q, k, v = torch.split(qkv_, [G_ * hd, hd, hd], dim=-1)
            q = q.reshape(B, S, G_, hd)
            s = torch.einsum("bsgd,btd->bgst", q, k) / scale
            s = torch.where(mask.on(s)[None, None], s, -1e30)
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bgst,btd->bsgd", p, v).reshape(
                B, S, G_ * hd)

        core = b.op(f"L{layer_i}.g{g}.attn", "elementwise", [roped],
                    [TensorSpec((B, S, G * hd))],
                    flops=attention_flops(B, S, S, G, hdF),
                    fn=attn_fn)
        out = b.op(f"L{layer_i}.g{g}.out", "matmul", [core],
                   [TensorSpec((B, S, d))],
                   flops=matmul_flops(S, dF, G * hdF, B),
                   fn=lambda c, wo_=wo_g: c @ wo_.on(c))
        outs.append(out)
    return b.op(f"L{layer_i}.head_merge", "elementwise", outs,
                [TensorSpec((B, S, cfg.d_model))],
                flops=elementwise_flops(B * S * dF * len(outs)),
                fn=lambda *hs: sum(hs))


def _export_mlp(b, cfg, mp, h, layer_i, B, S, fc=None):
    fc = fc or cfg
    d, ff = cfg.d_model, cfg.d_ff
    dF, ffF = fc.d_model, fc.d_ff
    if mp.w_gate is not None:
        wg, wu, wd = (_PerDevice(_f32(w))
                      for w in (mp.w_gate, mp.w_up, mp.w_down))
        gate = b.op(f"L{layer_i}.mlp.gate", "matmul", [h],
                    [TensorSpec((B, S, ff))],
                    flops=matmul_flops(S, ffF, dF, B),
                    fn=lambda x, w=wg: F.silu(x @ w.on(x)))
        up = b.op(f"L{layer_i}.mlp.up", "matmul", [h],
                  [TensorSpec((B, S, ff))],
                  flops=matmul_flops(S, ffF, dF, B),
                  fn=lambda x, w=wu: x @ w.on(x))
        mul = b.op(f"L{layer_i}.mlp.mul", "elementwise", [gate, up],
                   [TensorSpec((B, S, ff))],
                   flops=elementwise_flops(B * S * ffF),
                   fn=lambda a, c: a * c)
        return b.op(f"L{layer_i}.mlp.down", "matmul", [mul],
                    [TensorSpec((B, S, d))],
                    flops=matmul_flops(S, dF, ffF, B),
                    fn=lambda x, w=wd: x @ w.on(x))
    wu, wd, bu, bd = (_PerDevice(_f32(w))
                      for w in (mp.w_up, mp.w_down, mp.b_up, mp.b_down))
    up = b.op(f"L{layer_i}.mlp.up", "matmul", [h],
              [TensorSpec((B, S, ff))], flops=matmul_flops(S, ffF, dF, B),
              fn=lambda x, w=wu, bb=bu: F.gelu(x @ w.on(x) + bb.on(x),
                                               approximate="tanh"))
    return b.op(f"L{layer_i}.mlp.down", "matmul", [up],
                [TensorSpec((B, S, d))], flops=matmul_flops(S, dF, ffF, B),
                fn=lambda x, w=wd, bb=bd: x @ w.on(x) + bb.on(x))


def _export_moe(b, cfg, mp, h, layer_i, B, S, fc=None):
    """Router (dynamic -> fallback) + per-expert 2-node branches.

    The router's top-k is a control_flow op (unsupported: data-dependent
    dispatch); each expert is a delegate-eligible chain — exactly the
    heterogeneous mix Parallax targets.  Every expert node computes on
    every token (the combine weights the non-routed ones by 0), as the
    JAX exporter does; the shared expert, which JAX's exporter leaves
    out, is left out here too."""
    fc = fc or cfg
    m = cfg.moe
    d, ff = cfg.d_model, m.d_ff_expert
    dF, ffF = fc.d_model, fc.moe.d_ff_expert
    E, k = m.num_experts, m.num_experts_per_tok
    router_w = _PerDevice(_f32(mp.router))

    gates = b.op(
        f"L{layer_i}.router", "control_flow", [h],
        [TensorSpec((B, S, E))], flops=matmul_flops(S, E, dF, B),
        supported=False,
        fn=lambda x, w=router_w: _topk_gates(x, w.on(x), k))

    # per-expert FLOPs at the *routed share* of tokens (k/E of them),
    # matching how a runtime graph sees expert workloads.  gate+up are one
    # fused node (attrs N=2 — converters fuse the SwiGLU pair) so each
    # expert stays a clean Sequential chain of original-op count 3.
    share = max(k / E, 1e-3)
    w_gate, w_up, w_down = _f32(mp.w_gate), _f32(mp.w_up), _f32(mp.w_down)
    outs = []
    for e in range(E):
        g1 = b.op(f"L{layer_i}.e{e}.gateup", "matmul", [h],
                  [TensorSpec((B, S, ff))],
                  flops=2 * matmul_flops(S, ffF, dF, B) * share,
                  fn=lambda x, w=_PerDevice(w_gate[e]),
                  w2=_PerDevice(w_up[e]): F.silu(x @ w.on(x))
                  * (x @ w2.on(x)),
                  N=2)
        dn = b.op(f"L{layer_i}.e{e}.down", "matmul", [g1],
                  [TensorSpec((B, S, d))],
                  flops=matmul_flops(S, dF, ffF, B) * share,
                  fn=lambda a, w=_PerDevice(w_down[e]): a @ w.on(a))
        outs.append(dn)

    def combine(gates_, *expert_outs):
        y = torch.zeros_like(expert_outs[0])
        for e, eo in enumerate(expert_outs):
            y = y + gates_[..., e:e + 1] * eo
        return y

    return b.op(f"L{layer_i}.moe_combine", "elementwise",
                [gates] + outs, [TensorSpec((B, S, d))],
                flops=elementwise_flops(B * S * dF * E), fn=combine)


def _topk_gates(x, w, k):
    """(B, S, d) -> (B, S, E) gates: the top-k softmax probabilities,
    renormalised, at their experts; zero elsewhere."""
    probs = torch.softmax(x @ w, dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return torch.zeros_like(probs).scatter(-1, idx, vals)


def _export_mamba(b, cfg, mp, h, layer_i, B, S, fc=None):
    """Mamba2 mixer as a 4-node sequential chain: in_proj (matmul) ->
    causal conv -> SSD scan -> out_proj (matmul).  The scan is a
    control-flow (dynamic recurrence) op marked ``supported=False`` —
    the paper's 'unsupported kernel' class, which the config's notes
    name as the Parallax delegate model.  Its fn runs the SSD through the
    ``ssd_scan`` kernel wrapper with JAX's chunk rule (the config's chunk
    when it divides S, else one chunk of S): the kernel where the node
    runs on the card (the homogeneous executors), its plain version where
    ``parallax-hetero`` places the scan's branch on the host, as the
    paper's fallback does."""
    fc = fc or cfg
    d = cfg.d_model
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    d_innerF, nheadsF, conv_dimF = _dims(fc)
    proj_w = _PerDevice(_f32(mp.in_proj))
    out_w = _PerDevice(_f32(mp.out_proj))
    # the fp32 tail of mamba_block: A_log, D, dt_bias and norm_scale are
    # fp32 in every Mamba module
    tail = {k: _PerDevice(_f32(getattr(mp, k)))
            for k in ("A_log", "D", "dt_bias", "norm_scale")}
    F_ = proj_w.shape[1]

    FF = 2 * d_innerF + 2 * fc.ssm.n_groups * fc.ssm.d_state + nheadsF
    zx = b.op(f"L{layer_i}.in_proj", "matmul", [h],
              [TensorSpec((B, S, F_))],
              flops=matmul_flops(S, FF, fc.d_model, B),
              fn=lambda x, w=proj_w: x @ w.on(x))

    def conv_fn(zxbcdt, w=_PerDevice(_f32(mp.conv_w)),
                b=_PerDevice(_f32(mp.conv_b))):
        return _conv_part(cfg, zxbcdt, w.on(zxbcdt), b.on(zxbcdt))

    cv = b.op(f"L{layer_i}.conv", "conv", [zx],
              [TensorSpec((B, S, F_))],
              flops=B * S * conv_dimF * fc.ssm.conv_width * 2, fn=conv_fn)

    def scan_fn(zx_conv, c=tail):
        p = SimpleNamespace(**{k: v.on(zx_conv) for k, v in c.items()})
        z, xBC, dt = _split_proj(cfg, zx_conv)
        xs, Bm, Cm, dtv, A = _ssm_inputs(p, cfg, xBC, dt)
        chunk = s.chunk if S % s.chunk == 0 else S
        y = ssd_scan(xs, dtv, A, Bm, Cm, chunk=chunk)
        return _gated_norm(p, y, xs, z, torch.float32)

    sc = b.op(f"L{layer_i}.ssd_scan", "elementwise", [cv],
              [TensorSpec((B, S, d_inner))],
              flops=ssd_scan_flops(B, S, nheadsF, fc.ssm.head_dim,
                                   fc.ssm.d_state),
              supported=False, fn=scan_fn)
    return b.op(f"L{layer_i}.out_proj", "matmul", [sc],
                [TensorSpec((B, S, d))],
                flops=matmul_flops(S, fc.d_model, d_innerF, B),
                fn=lambda y, w=out_w: y @ w.on(y))


def _conv_part(cfg, zxbcdt, conv_w, conv_b):
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC, conv_w, conv_b)
    return torch.cat([z, xBC, dt], dim=-1)


def export_graph(cfg, params, batch: int, seq: int, flops_cfg=None):
    """Dispatch by family.  Encoder-decoder exports the encoder side."""
    if cfg.is_encoder_decoder:
        return export_encoder_graph(cfg, params, batch, seq, flops_cfg)
    return export_decoder_graph(cfg, params, batch, seq, flops_cfg)


def export_encoder_graph(cfg, params, batch: int, seq: int,
                         flops_cfg=None):
    raise NotImplementedError(
        "the Whisper encoder DAG arrives with the Whisper slice")
