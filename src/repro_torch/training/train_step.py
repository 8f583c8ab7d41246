"""Training step factory: loss -> grads -> AdamW update.

Port of ``repro.training.train_step``.  ``jax.value_and_grad`` becomes
``torch.autograd.grad`` of ``api.loss_fn`` with respect to the module's
parameters, whose gradients the step turns on; ``jax.lax.scan`` over
microbatches becomes a loop.  The step updates the module in place
(``apply_updates`` writes the stepped fp32 masters back into it) and
returns it, so a loop reads like JAX's.
"""

from __future__ import annotations

import torch

from .optimizer import OptConfig, apply_updates, init_opt_state, named_params


def loss_and_grads(api, params, batch):
    """``api.loss_fn`` and its gradient.  Returns (loss, metrics, grads):
    the loss and metrics detached, grads a dict of name -> gradient in
    the parameter's dtype (zeros for a parameter the loss does not
    reach, as JAX gives)."""
    named = named_params(params)
    for p in named.values():
        p.requires_grad_(True)
    loss, metrics = api.loss_fn(params, batch)
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), gs)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _slice(v, i: int, n: int):
    """Microbatch ``i`` of ``n``: rows ``i*B/n`` to ``(i+1)*B/n`` of the
    leading dim, which must split evenly (JAX's reshape to ``(n, B // n)``
    raises otherwise).  A DTensor batch (the dry-run's) takes the same
    rows of each rank's shard, so no row moves between ranks."""
    from torch.distributed.tensor import DTensor

    if not isinstance(v, DTensor):
        if len(v) % n:
            raise ValueError(f"{len(v)} rows do not split into {n} "
                             f"microbatches")
        rows = len(v) // n
        return v[i * rows:(i + 1) * rows]
    loc = v.to_local()
    if loc.shape[0] % n:
        raise ValueError(f"{loc.shape[0]} local rows do not split into "
                         f"{n} microbatches")
    rows = loc.shape[0] // n
    return DTensor.from_local(loc[i * rows:(i + 1) * rows], v.device_mesh,
                              v.placements, run_check=False)


def make_train_step(api, opt_cfg: "OptConfig | None" = None,
                    microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` for any ModelAPI; metrics ``loss``, ``ce``,
    ``aux`` (decoder models), ``grad_norm`` and ``lr`` as device
    scalars.

    ``microbatches > 1`` enables gradient accumulation: the global batch
    is split on its leading dim and run slice by slice, dividing peak
    activation memory by the microbatch count.  Gradients accumulate in
    fp32, in slice order, then divide by the count; the loss and metrics
    are the slices' means, as in JAX.  A leading dim that does not split
    evenly raises ``ValueError``, as JAX's reshape does, and so does a
    batch with M-RoPE ``positions3``: JAX would cut its (3, B, S) stream
    axis, and splitting on its batch axis is not what JAX does.
    """
    opt_cfg = opt_cfg or OptConfig()

    def train_step(params, opt_state, batch):
        if microbatches > 1 and "positions3" in batch:
            # JAX splits every leaf on its leading dim, which for the
            # (3, B, S) M-RoPE streams is the stream axis
            raise ValueError("M-RoPE positions3 (3, B, S) do not split "
                             "into microbatches")
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(api, params, batch)
        else:
            grads, losses, ms = None, [], []
            for i in range(microbatches):
                part = {k: _slice(v, i, microbatches)
                        for k, v in batch.items()}
                loss_i, m_i, g = loss_and_grads(api, params, part)
                if grads is None:
                    grads = {n: torch.zeros(t.shape, dtype=torch.float32,
                                            device=t.device)
                             for n, t in g.items()}
                for n, t in g.items():
                    grads[n] += t.float()
                losses.append(loss_i)
                ms.append(m_i)
            grads = {n: t / microbatches for n, t in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


__all__ = ["make_train_step", "loss_and_grads", "OptConfig",
           "init_opt_state", "apply_updates"]
