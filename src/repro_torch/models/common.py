"""Shared model primitives: norms, activations, RoPE, initialisers.

Port of ``repro.models.common``.  Parameters live in ``nn.Module``s
(see :mod:`.blocks`, :mod:`.transformer`); every function here is
``fn(params, x, ...) -> y`` on tensors, with the same arithmetic as the
JAX reference: norms in fp32 with the result cast back, RoPE in fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """Inference-only parameter (serving never takes gradients)."""
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def _normal(gen, shape, device):
    if gen is None:              # filled later (e.g. by the params bridge)
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, shape, device, dtype, in_axis=-2):
    """LeCun-normal: N(0, 1) / sqrt(fan_in), drawn in fp32 and stored in
    ``dtype`` (the JAX package keeps fp32 masters and casts at every use,
    which gives the same values)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return (_normal(gen, shape, device) / np.sqrt(fan_in)).to(dtype)


def embed_init(gen, shape, device, dtype):
    return (_normal(gen, shape, device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), fp32."""

    def __init__(self, d: int, norm_type: str, device):
        super().__init__()
        if norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        self.scale = param(torch.ones(d, device=device))
        if norm_type == "layernorm":
            self.bias = param(torch.zeros(d, device=device))


def rms_norm(scale, x, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(params, x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params.scale.float() + params.bias.float()).to(x.dtype)


def norm(params: Norm, x):
    if params.norm_type == "rmsnorm":
        return rms_norm(params.scale, x)
    return layer_norm(params, x)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                      dtype=np.float32) / head_dim))


def apply_rope(x, positions, inv_freq):
    """x: (..., S, H, head_dim); positions broadcastable to (..., S);
    ``inv_freq`` is :func:`rope_freqs` as a float32 tensor on x's
    device."""
    ang = positions[..., :, None, None].float() * inv_freq  # (...,S,1,hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
