"""Output projection helpers (tied / untied vocab heads).

Port of ``repro.models.vocab``: logits stay in the activation dtype.
"""

from __future__ import annotations

import torch

from .sharding import (DP_AXES, active_mesh, axes_of, fit, from_local,
                       maybe_shard, pmax, psum, shard_batch, to_local)


def embed_lookup(embed, tokens):
    """``embed[tokens]``: (V, d) rows for int tokens of any shape.  A
    DTensor table under an active mesh is looked up vocab-parallel: the
    table gathered over its data (FSDP) shards, each ``model`` rank
    reading the tokens in its vocab slice, zeros elsewhere, summed over
    ``model`` (XLA partitions the reference's gather so; DTensor would
    gather the table whole and, in the backward, every rank's
    gradient)."""
    from torch.distributed.tensor import DTensor

    mesh = active_mesh()
    if mesh is None or not isinstance(embed, DTensor):
        return embed[tokens]
    t_spec = fit(embed.shape, "model", None)
    r_spec = fit(tokens.shape, DP_AXES, *([None] * (tokens.ndim - 1)))
    table = to_local(embed, t_spec, mesh)
    tok = to_local(tokens, r_spec, mesh)
    v_axes = ("model",) if t_spec[0] is not None else ()
    V_l = table.shape[0]
    local = tok.long() - (mesh.get_local_rank("model") * V_l
                          if v_axes else 0)
    here = ((local >= 0) & (local < V_l))[..., None]
    rows = torch.where(here, table[local.clamp(0, V_l - 1)],
                       table.new_zeros(()))
    return from_local(psum(rows, mesh, v_axes), tuple(r_spec) + (None,),
                      mesh, tuple(tokens.shape) + (embed.shape[1],))


def lm_logits(params, cfg, hidden):
    """(B, S, d) -> (B, S, V): the full logits (the training loss)."""
    hidden = shard_batch(hidden)
    if cfg.tie_embeddings:
        logits = hidden @ params.embed.t()
    else:
        logits = hidden @ params.lm_head
    return maybe_shard(logits, DP_AXES, None, "model")


def logits_last_token(params, cfg, hidden):
    """(B, S, d) -> (B, V) logits for the final position only."""
    last = shard_batch(hidden)[:, -1, :]
    if cfg.tie_embeddings:
        logits = last @ params.embed.t()
    else:
        logits = last @ params.lm_head
    return maybe_shard(logits, DP_AXES, "model")


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy in fp32 over the labels >= 0 (JAX's
    ``lm_loss`` / ``encdec_loss``: log-softmax in fp32, -1 labels
    masked, the sum over at least one).  DTensor logits under an active
    mesh take :func:`_cross_entropy_sharded`."""
    from torch.distributed.tensor import DTensor

    mesh = active_mesh()
    if mesh is not None and isinstance(logits, DTensor):
        return _cross_entropy_sharded(logits, labels, mesh)
    mask = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def _cross_entropy_sharded(logits, labels, mesh):
    """Vocab-parallel cross-entropy on each rank's (rows, vocab) shard:
    the log-sum-exp from an all-reduced max and sum over the ``model``
    ranks, each label's logit from the rank that holds it, the masked sum
    and count over the data ranks.  XLA partitions the reference's
    log-softmax so; DTensor would gather the whole vocab (and the
    gradient of its gather is a dense tensor of the global shape).
    Returns the replicated loss as a plain tensor."""
    l_spec = fit(logits.shape, DP_AXES, None, "model")
    r_spec = fit(labels.shape, DP_AXES, None)
    lg, lab = to_local(logits, l_spec, mesh), to_local(labels, r_spec, mesh)
    v_axes = ("model",) if l_spec[2] is not None else ()
    V_l = lg.shape[-1]
    lo = mesh.get_local_rank("model") * V_l if v_axes else 0
    lg = lg.float()
    m = pmax(lg.amax(-1), mesh, v_axes)
    lse = torch.log(psum(torch.exp(lg - m[..., None]).sum(-1), mesh,
                         v_axes)) + m
    local = lab.long() - lo
    here = (local >= 0) & (local < V_l)
    picked = torch.gather(lg, -1, local.clamp(0, V_l - 1)[..., None])[..., 0]
    picked = psum(torch.where(here, picked, 0.0), mesh, v_axes)
    mask = lab >= 0
    d_axes = axes_of(r_spec[0])
    total = psum(((lse - picked) * mask).sum(), mesh, d_axes)
    count = psum(mask.sum().float(), mesh, d_axes)
    return total / count.clamp(min=1)
