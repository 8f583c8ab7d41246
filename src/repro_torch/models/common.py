"""Shared model primitives: norms, activations, RoPE, initialisers, remat.

Port of ``repro.models.common``.  Parameters live in ``nn.Module``s
(see :mod:`.blocks`, :mod:`.transformer`); every function here is
``fn(params, x, ...) -> y`` on tensors, with the same arithmetic as the
JAX reference: norms in fp32 with the result cast back, RoPE and
Qwen2-VL's M-RoPE in fp32, Whisper's sinusoidal positions in float64
then fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter stored as given (the model dtype, or fp32), with
    gradients off: serving takes none, and the trainer
    (``repro_torch.training.make_train_step``) turns them on."""
    return nn.Parameter(t, requires_grad=False)


def remat(fn, *args):
    """``fn(*args)``, rematerialised while gradients are on (JAX's
    ``jax.checkpoint``): its activations are recomputed in the backward
    pass, which runs ``fn``'s kernels a second time."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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
    w = _normal(gen, shape, device)
    w /= np.sqrt(fan_in)           # in place: one fp32 copy at a time
    return w.to(dtype)


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


@functools.lru_cache(maxsize=8)
def _section_ids(sections: tuple, device: torch.device) -> torch.Tensor:
    """(half,) long: the position stream (0 t, 1 h, 2 w) of each
    frequency band, the bands contiguous in stream order."""
    ids = np.concatenate([np.full((s,), i) for i, s in enumerate(sections)])
    return torch.from_numpy(ids).to(device)


def apply_mrope(x, positions3, sections, inv_freq):
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).

    x: (..., S, H, head_dim); ``positions3`` (3, ..., S): temporal,
    height and width position ids (all equal for text tokens);
    ``sections`` split the *rotary half* of head_dim among the three
    streams, e.g. (16, 24, 24) at head_dim 128.  Each stream's angles
    are :func:`apply_rope`'s, and each band takes its stream's by
    selection, so three equal streams give :func:`apply_rope`'s bits."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not split "
                         f"the rotary half {half}")
    sect = _section_ids(tuple(sections), x.device)
    t, h, w = (positions3[i][..., :, None, None].float() * inv_freq
               for i in range(3))                     # (..., S, 1, half)
    ang = torch.where(sect == 0, t, torch.where(sect == 1, h, w))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None):
    """Whisper-style fixed sinusoidal embeddings (length, dim): computed
    in float64 with numpy, as the JAX package does, then float32."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.tensor(emb, dtype=torch.float32, device=device)
