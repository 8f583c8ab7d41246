"""AdamW with dtype-configurable moments and fp32 master weights.

Port of ``repro.training.optimizer``: the same arithmetic — global-norm
clip in fp32, linear warmup, bias correction, decoupled weight decay,
moments stored in ``moment_dtype`` — in plain PyTorch.

Master weights.  The JAX package keeps every parameter as an fp32 master
and casts it at each use.  The port stores its weights in the model
dtype (``models.common.param``), so the optimizer state holds the fp32
masters beside ``m``, ``v`` and ``step``: :func:`apply_updates` steps the
masters and writes their rounded values back into the parameters.  A
gradient taken with respect to the bf16 value, widened to fp32, is what
the VJP of JAX's cast gives, so this is JAX's update exactly.  A
parameter the port already keeps in fp32 (norm scales, the MoE router,
the SSM's ``A_log``, ``D`` and ``dt_bias``) is its own master: its
master shares its storage.

``params`` is an ``nn.Module`` or a dict of name -> tensor; the state's
dicts are keyed by the same names (``Module.named_parameters()``).
Parameters are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.device import torch_dtype

#: elements of parameters an optimizer pass takes at once: its fp32
#: temporaries stay under ~5 x 4 bytes a parameter of that (2.5 GiB)
CHUNK_ELEMS = 1 << 27


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def named_params(params) -> "dict[str, torch.Tensor]":
    """An ``nn.Module``'s named parameters, or a name -> tensor dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, cfg: OptConfig) -> dict:
    """``{"master", "m", "v"}``: dicts of name -> tensor; ``"step"``: int32
    scalar on the parameters' device."""
    named = named_params(params)
    mdt = torch_dtype(cfg.moment_dtype)
    device = next(iter(named.values())).device
    with torch.no_grad():
        return {
            "master": {n: p.detach() if p.dtype == torch.float32
                       else p.detach().float() for n, p in named.items()},
            # zeros_like: a DTensor parameter's moments are placed as it is
            "m": {n: torch.zeros_like(p, dtype=mdt)
                  for n, p in named.items()},
            "v": {n: torch.zeros_like(p, dtype=mdt)
                  for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.stack([g.float().square().sum()
                        for g in grads.values()]).sum().sqrt()


def _schedule(cfg: OptConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _chunks(named, limit: int = CHUNK_ELEMS):
    """The parameter names in order, cut into runs of at most ``limit``
    elements (a larger parameter alone)."""
    runs, size = [[]], 0
    for name, p in named.items():
        if runs[-1] and size + p.numel() > limit:
            runs.append([])
            size = 0
        runs[-1].append(name)
        size += p.numel()
    return runs


def _copy_(dst, src):
    """``torch._foreach_copy_``; tensor by tensor for DTensors (the
    dry-run's), which have no sharding strategy for it."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst[0], DTensor):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        torch._foreach_copy_(dst, src)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One AdamW step.  ``grads``: name -> gradient (any float dtype).
    Returns (params, state, metrics); params, masters and moments are
    updated in place, ``state["step"]`` is a new tensor.  Each operation
    runs once over a run of parameters (``torch._foreach_*``), in fp32;
    the runs bound the temporaries (:data:`CHUNK_ELEMS`)."""
    named = named_params(params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for names in _chunks(named):
        master, m, v = ([state[k][n] for n in names]
                        for k in ("master", "m", "v"))
        g = torch._foreach_mul([grads[n].float() for n in names], scale)
        m32 = [t.float() for t in m]          # the moments, when fp32
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g, alpha=1 - b1)
        v32 = [t.float() for t in v]
        torch._foreach_mul_(v32, b2)
        torch._foreach_mul_(g, g)
        torch._foreach_add_(v32, g, alpha=1 - b2)
        denom = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m32, bc1)
        torch._foreach_div_(delta, denom)
        torch._foreach_add_(delta, master, alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(master, delta)
        if m32[0] is not m[0]:                # rounded to moment_dtype
            _copy_(m, m32)
            _copy_(v, v32)
        # an fp32 parameter is its own master (init_opt_state)
        low = [(named[n], t) for n, t in zip(names, master)
               if named[n].dtype != t.dtype]
        if low:                               # rounded to the model dtype
            _copy_([p for p, _ in low], [t for _, t in low])
    state = dict(state, step=step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
