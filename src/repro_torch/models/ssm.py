"""Mamba2 blocks via SSD — state-space duality (arXiv:2405.21060).

Port of ``repro.models.ssm``.  The SSD layer computes, per head h with
state size N and head dim P:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T      (N x P state)
    y_t = C_t^T h_t + D x_t

The full-sequence block (:func:`mamba_block`) runs the chunked scan
through the ``ssd_scan`` kernel (its plain version, ``ssd_chunked``, on
CPU tensors); the decode step (:func:`mamba_decode_step`) is the
recurrence one token at a time and calls no kernel, in JAX or here.
``segsum``, ``ssd_chunked`` and ``ssd_scan_ref`` live beside the kernel
(:mod:`repro_torch.kernels.ssd_scan.ref`) and are re-exported here.

Block layout follows Mamba2: in_proj -> [z | xBC | dt], causal conv1d on
xBC, SSD, gated RMSNorm, out_proj.  Precision is the JAX package's:
the projections and the conv run in the activation dtype, the SSD in
fp32 on fp32 ``x``, ``B`` and ``C``, ``dt = softplus(dt + dt_bias)`` in
fp32, and ``y * silu(z)`` in the activation dtype before the fp32 RMS
norm.  The decode cache is ``{"state": (b, H, P, N) fp32, "conv": (b,
conv_width - 1, conv_dim)}``; the step returns new tensors and never
writes the old ones, so a caller's reference to the old cache is a free
checkpoint (the serving engine's dispatch rollback rests on it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (segsum, ssd_chunked,
                                              ssd_scan_ref)

from .common import dense_init, param, rms_norm

__all__ = ["Mamba", "init_mamba", "init_mamba_cache", "mamba_block",
           "mamba_decode_step", "segsum", "ssd_chunked", "ssd_decode_step",
           "ssd_scan_ref"]


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrent update (decode path).

    state: (b,H,P,N); x: (b,H,P); dt: (b,H); B, C: (b,G,N).
    Returns (y (b,H,P), new_state).
    """
    G = B.shape[1]
    H = x.shape[1]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=1)
    Ch = C.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * A[None, :])
    upd = torch.einsum("bhn,bhp->bhpn", Bh, x * dt[..., None])
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    return y, state


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim


class Mamba(nn.Module):
    """A Mamba2 mixer's parameters.  The JAX package keeps fp32 masters and
    casts at use; here ``in_proj``, ``conv_w``, ``conv_b`` and
    ``out_proj`` are stored cast to the model dtype, and ``A_log``,
    ``D``, ``dt_bias`` and ``norm_scale`` stay fp32, where JAX reads
    them."""

    def __init__(self, cfg, gen, device, dtype):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, nheads, conv_dim = _dims(cfg)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = param(dense_init(
            gen, (d, 2 * d_inner + 2 * s.n_groups * s.d_state + nheads),
            device, dtype))
        self.conv_w = param((dense_init(gen, (s.conv_width, conv_dim),
                                        device, torch.float32) * 0.1)
                            .to(dtype))
        self.conv_b = param(torch.zeros(conv_dim, device=device,
                                        dtype=dtype))
        self.A_log = param(torch.log(torch.linspace(1.0, 16.0, nheads,
                                                    **f32)))
        self.D = param(torch.ones(nheads, **f32))
        self.dt_bias = param(torch.zeros(nheads, **f32))
        self.norm_scale = param(torch.ones(d_inner, **f32))
        self.out_proj = param(dense_init(gen, (d_inner, d), device, dtype))


def init_mamba(gen, cfg, device, dtype) -> Mamba:
    return Mamba(cfg, gen, device, dtype)


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    gN = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gN, nheads], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d over (b, S, C): JAX's sum of ``conv_width``
    shifted products, in its order (not ``F.conv1d``), so the decode
    step's rolling window reproduces it."""
    Kw = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, Kw - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(Kw))
    return F.silu(out + b[None, None, :])


def _ssm_inputs(params: Mamba, cfg, xBC, dt):
    """Split the conv output into the SSD operands (views, no copies),
    ``dt`` through softplus in fp32, and ``A``."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    gN = s.n_groups * s.d_state
    xs, B, C = torch.split(xBC, [d_inner, gN, gN], dim=-1)
    lead = xBC.shape[:-1]
    xs = xs.reshape(*lead, nheads, s.head_dim)
    B = B.reshape(*lead, s.n_groups, s.d_state)
    C = C.reshape(*lead, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params.dt_bias)
    return xs, B, C, dt, -torch.exp(params.A_log)


def _gated_norm(params: Mamba, y, xs, z, dtype):
    """``+ D x`` in fp32, then the gated RMS norm ``norm(y * silu(z))``
    with ``y * silu(z)`` in ``dtype`` (heads merged: (..., d_inner))."""
    y = y + params.D[:, None] * xs.float()
    y = y.reshape(*y.shape[:-2], -1).to(dtype)
    return rms_norm(params.norm_scale, y * F.silu(z))


def mamba_block(params: Mamba, cfg, x):
    """Full-sequence Mamba2 block.  x: (b, S, d) -> (b, S, d).

    S must be a multiple of ``cfg.ssm.chunk`` (JAX's ``ssd_chunked``
    asserts it).  One ``ssd_scan`` launch per call on the card; its
    ``x``, ``B`` and ``C`` are strided views of the conv output (copied
    only by the fp32 cast of a bf16 model)."""
    zxbcdt = x @ params.in_proj
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC, params.conv_w, params.conv_b)
    xs, B, C, dt, A = _ssm_inputs(params, cfg, xBC, dt)
    y = ssd_scan(xs.float(), dt, A, B.float(), C.float(),
                 chunk=cfg.ssm.chunk)
    return _gated_norm(params, y, xs, z, x.dtype) @ params.out_proj


def init_mamba_cache(cfg, batch: int, dtype, device):
    s = cfg.ssm
    d_inner, nheads, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_decode_step(params: Mamba, cfg, x, cache):
    """Single-token decode.  x: (b, 1, d) -> (y (b,1,d), new_cache).

    The new cache holds new tensors; ``cache`` is left as it was.  Row
    gating lives in the caller (``blocks.decode_block`` selects new or
    old state per row by ``active``), which is what lets a megastep's
    finished rows stop mutating their SSM state mid-loop.  The conv is
    the shifted sum of :func:`_causal_conv` over the rolling window, in
    the same order.
    """
    zxbcdt = x @ params.in_proj
    z, xBC, dt = _split_proj(cfg, zxbcdt)                 # (b,1,*)
    win = torch.cat([cache["conv"], xBC], dim=1)          # (b,Kw,conv)
    w = params.conv_w
    out = sum(win[:, i:i + 1, :] * w[i][None, None, :]
              for i in range(w.shape[0]))
    xBC = F.silu(out + params.conv_b[None, None, :])
    xs, B, C, dtv, A = _ssm_inputs(params, cfg, xBC[:, 0], dt[:, 0])
    y, state = ssd_decode_step(cache["state"], xs.float(), dtv, A,
                               B.float(), C.float())
    y = _gated_norm(params, y, xs, z[:, 0], x.dtype) @ params.out_proj
    return y[:, None], {"state": state, "conv": win[:, 1:, :]}
