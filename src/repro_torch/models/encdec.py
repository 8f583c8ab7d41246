"""Whisper-style encoder-decoder (arXiv:2212.04356): training and serving.

Port of ``repro.models.encdec``.  The audio frontend (mel spectrogram +
2x conv subsampling) is a stub, as in the JAX package: ``frames`` are
precomputed frame embeddings (B, S_enc, d).  Downstream of it: sinusoidal
positions, the bidirectional encoder (``flash_attention`` with
``causal=False``), the causal decoder with cross-attention (in serving
one token a step through ``decode_attention``, self and cross; in
training every token at once through ``flash_attention``) and the tied
vocab head.

Parameters (:class:`EncDec`)::

    embed (V, d)   dec_pos (4096, d)   enc_final   dec_final
    encoder: [EncBlock, ...]  (cfg.encoder_layers)
    decoder: [DecBlock, ...]  (cfg.num_layers)

The JAX package scans stacked layers; here they are ``nn.ModuleList``s
walked in Python.  As in JAX, the decoder's self-attention applies RoPE
on top of the learned ``dec_pos`` (``qkv_project`` does), and the
encoder applies none; the teacher-forced training decoder
(:func:`decode_train`) applies none either, as JAX's does.
:func:`encdec_loss` is the training loss.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.kernels.flash_attention import attend_bshd

from .attention import (Attention, cross_attention, decode_step_attention,
                        init_kv_cache, qkv_project)
from .common import (Norm, embed_init, norm, param, remat,
                     sinusoidal_positions)
from .mlp import MLP, mlp
from .vocab import cross_entropy

#: rows of the learned decoder position table (JAX: ``dec_pos``)
DEC_POS_ROWS = 4096


class EncBlock(nn.Module):
    def __init__(self, cfg, gen, device, dtype):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = Attention(cfg, gen, device, dtype)
        self.norm2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, gen, device, dtype)


class DecBlock(nn.Module):
    def __init__(self, cfg, gen, device, dtype):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, cfg.norm_type, device)
        self.self_attn = Attention(cfg, gen, device, dtype)
        self.norm_x = Norm(cfg.d_model, cfg.norm_type, device)
        self.cross_attn = Attention(cfg, gen, device, dtype)
        self.norm2 = Norm(cfg.d_model, cfg.norm_type, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, gen, device, dtype)


class EncDec(nn.Module):
    def __init__(self, cfg, gen, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.embed = param(embed_init(gen, (cfg.vocab_size, d), device,
                                      dtype))
        self.dec_pos = param(embed_init(gen, (DEC_POS_ROWS, d), device,
                                        dtype))
        self.enc_final = Norm(d, cfg.norm_type, device)
        self.dec_final = Norm(d, cfg.norm_type, device)
        self.encoder = nn.ModuleList(EncBlock(cfg, gen, device, dtype)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecBlock(cfg, gen, device, dtype)
                                     for _ in range(cfg.num_layers))


def init_encdec(gen, cfg, device, dtype) -> EncDec:
    """Random init from ``gen`` (a ``torch.Generator`` on ``device``);
    ``gen=None`` allocates zeros for the params bridge to fill."""
    return EncDec(cfg, gen, device, dtype)


@functools.lru_cache(maxsize=8)
def _positions(length: int, dim: int, device: torch.device):
    """The sinusoidal table on ``device``, made once per shape (JAX folds
    it into its trace); callers never write to it."""
    return sinusoidal_positions(length, dim, device)


def encode(params: EncDec, cfg, frames):
    """frames: (B, S_enc, d) stub frontend embeddings -> (B, S_enc, d).
    The frames and the sinusoidal table are cast to the model dtype
    before they are added, as in JAX."""
    dt = params.embed.dtype
    S = frames.shape[1]
    x = frames.to(dt) + _positions(S, cfg.d_model, frames.device).to(
        dt)[None]
    for blk in params.encoder:
        x = x + _bidir_attention(blk.attn, cfg, norm(blk.norm1, x))
        x = x + mlp(blk.mlp, norm(blk.norm2, x))
    return norm(params.enc_final, x)


def _bidir_attention(p: Attention, cfg, x):
    """Encoder self-attention: no positions (no RoPE), no mask."""
    B, S, _ = x.shape
    q, k, v = qkv_project(p, cfg, x)
    ctx = attend_bshd(q, k, v, causal=False)
    return ctx.reshape(B, S, -1) @ p.wo


def cross_kv(p: Attention, cfg, enc_out):
    """One layer's cross-attention K/V (B, T, K, D) from the encoder
    output (computed once a request; no bias, as in JAX)."""
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    K = cfg.num_kv_heads
    return ((enc_out @ p.wk).reshape(B, T, K, hd),
            (enc_out @ p.wv).reshape(B, T, K, hd))


def _decoder_layer(blk: DecBlock, cfg, x, enc_out):
    """One teacher-forced decoder layer over x (B, S, d): causal
    self-attention with no RoPE (JAX's ``decode_train`` passes no
    positions), cross-attention over the layer's K/V of ``enc_out``
    (both through ``flash_attention``), the MLP."""
    B, S, _ = x.shape
    p = blk.self_attn
    q, k, v = qkv_project(p, cfg, norm(blk.norm1, x))
    x = x + attend_bshd(q, k, v, causal=True).reshape(B, S, -1) @ p.wo
    ck, cv = cross_kv(blk.cross_attn, cfg, enc_out)
    x = x + cross_attention(blk.cross_attn, cfg, norm(blk.norm_x, x), ck, cv)
    return x + mlp(blk.mlp, norm(blk.norm2, x))


def decode_train(params: EncDec, cfg, tokens, enc_out):
    """Teacher-forced decoder forward, tokens (B, S) -> hidden (B, S, d),
    each layer rematerialised while gradients are on (JAX's
    ``jax.checkpoint`` of its scan body): two ``flash_attention``
    launches a layer, and two more in its recompute."""
    S = tokens.shape[1]
    x = params.embed[tokens] + params.dec_pos[:S][None]
    for blk in params.decoder:
        x = remat(_decoder_layer, blk, cfg, x, enc_out)
    return norm(params.dec_final, x)


def encdec_loss(params: EncDec, cfg, frames, tokens, labels):
    """Mean cross-entropy of the tied vocab head over the decoder's
    hidden states (labels = -1 masked).  The encoder is not
    rematerialised, as in JAX.  Returns (loss, {"ce": loss})."""
    enc = encode(params, cfg, frames)
    hidden = decode_train(params, cfg, tokens, enc)
    loss = cross_entropy(hidden @ params.embed.t(), labels)
    return loss, {"ce": loss}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _cross_slots(batch: int, T: int, device):
    """``pos`` = arange(T) and ``cache_len`` = T - 1 for every row: every
    encoder position valid for ``decode_attention``."""
    return (torch.arange(T, dtype=torch.int32, device=device),
            torch.full((batch,), T - 1, dtype=torch.int32, device=device))


def init_dec_caches(cfg, batch, max_len, dtype, device, tile=16):
    """Per decoder layer a dense self-attention cache (see
    ``attention.init_kv_cache``), plus the cross K/V slots
    ``cross_k``/``cross_v`` (L, B, encoder_seq, K, D) and their
    ``cross_pos`` / ``cross_len``."""
    hd = cfg.resolved_head_dim()
    shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
    pos, lens = _cross_slots(batch, cfg.encoder_seq, device)
    return {"self": [init_kv_cache(cfg, batch, max_len, dtype, device,
                                   tile=tile)
                     for _ in range(cfg.num_layers)],
            "cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device),
            "cross_pos": pos, "cross_len": lens}


def prefill_encdec(params: EncDec, cfg, frames, caches):
    """Encoder pass + cross K/V (the serving prefill).  Returns (enc,
    caches): a new dict whose ``cross_k``/``cross_v`` (and their
    ``cross_pos``/``cross_len``) follow the frames' length, as JAX's
    dict replacement does; the self caches are the ones passed in."""
    enc = encode(params, cfg, frames)
    ks, vs = zip(*(cross_kv(blk.cross_attn, cfg, enc)
                   for blk in params.decoder))
    caches = dict(caches)
    caches["cross_k"] = torch.stack(ks).to(caches["cross_k"].dtype)
    caches["cross_v"] = torch.stack(vs).to(caches["cross_v"].dtype)
    caches["cross_pos"], caches["cross_len"] = _cross_slots(
        enc.shape[0], enc.shape[1], enc.device)
    return enc, caches


def decode_step_encdec(params: EncDec, cfg, caches, tokens, cache_len,
                       active=None):
    """One decoder token.  tokens: (B, 1) -> (logits (B, V), caches).

    ``cache_len`` may be a scalar or a (B,) vector of per-row positions;
    ``active`` gates per-row self-cache writes (see
    ``attention.decode_step_attention``).  Each layer launches
    ``decode_attention`` twice: its self-attention over the dense cache,
    updated in place, and its cross-attention over the encoder's K/V.
    """
    dt = params.embed.dtype
    pos = torch.as_tensor(cache_len, dtype=torch.int32,
                          device=params.embed.device)
    # (B or 1, d): a gather, which reads no index back to the host
    pe = params.dec_pos.index_select(0, pos.reshape(-1).long())
    x = params.embed[torch.as_tensor(tokens, device=pos.device)] \
        + pe[:, None, :]
    for blk, self_cache, ck, cv in zip(params.decoder, caches["self"],
                                       caches["cross_k"], caches["cross_v"]):
        y, _ = decode_step_attention(blk.self_attn, cfg,
                                     norm(blk.norm1, x), self_cache, pos,
                                     active=active)
        x = x + y
        x = x + cross_attention(blk.cross_attn, cfg, norm(blk.norm_x, x),
                                ck.to(dt), cv.to(dt), caches["cross_pos"],
                                caches["cross_len"])
        x = x + mlp(blk.mlp, norm(blk.norm2, x))
    hidden = norm(params.dec_final, x)[:, -1, :]
    return hidden @ params.embed.t(), caches
