"""Activation-sharding helpers that degrade gracefully off-mesh.

Port of ``repro.models.sharding``.  Models call :func:`maybe_shard` at
block boundaries.  Under an active mesh (:func:`set_mesh`, the port's
stand-in for ``jax.sharding.set_mesh``) a DTensor is redistributed to the
spec's placements over the mesh axes that exist; with no mesh (every
path but the dry-run's and ``moe_ep``'s) it returns ``x`` itself, so the
same model code runs everywhere and off-mesh results stay bit-identical.

Where XLA pads a dim that an axis does not divide, the port leaves that
dim unsharded (the rank's local shard is the same size either way when
the dim is smaller than the axis, as at batch 1).

JAX's ``dp()`` and ``shard_batch_heads`` are left out: no model code
calls them there or here (attention states its (batch, head) split in
``attention.on_shards``).
"""

from __future__ import annotations

import contextlib

import torch

# data-parallel axes in priority order; ("pod", "data") on the multi-pod
# mesh, ("data",) on the single-pod mesh.
DP_AXES = ("pod", "data")
MODEL_AXIS = "model"

_mesh = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh inside the block."""
    _mesh.append(mesh)
    try:
        yield mesh
    finally:
        _mesh.pop()


def active_mesh():
    """The innermost :func:`set_mesh` mesh, or None."""
    return _mesh[-1] if _mesh else None


def active_axes():
    mesh = active_mesh()
    return () if mesh is None else tuple(mesh.mesh_dim_names)


def _filter(entry, axes):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in axes else None
    sub = tuple(a for a in entry if a in axes)
    if not sub:
        return None
    return sub if len(sub) > 1 else sub[0]


def spec(*entries):
    """The entries filtered to the active mesh's axes, or None off-mesh."""
    from repro_torch.utils.sharding import P

    axes = active_axes()
    if not axes:
        return None
    return P(*[_filter(e, axes) for e in entries])


def _dividing(s, shape, mesh):
    """``s`` with every axis that does not divide its dim dropped."""
    from repro_torch.utils.sharding import P, axis_sizes

    sizes = axis_sizes(mesh)
    out = []
    for entry, dim in zip(s, shape):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        keep, n = [], 1
        for a in axes:
            if dim % (n * sizes[a]) == 0:
                keep.append(a)
                n *= sizes[a]
        out.append(None if not keep else
                   (keep[0] if len(keep) == 1 else tuple(keep)))
    return P(*out)


def fit(shape, *entries):
    """``spec(*entries)`` for a tensor of ``shape`` under the active mesh,
    the axes that do not divide their dim dropped."""
    return _dividing(spec(*entries), shape, active_mesh())


def to_local(t, s, mesh):
    """This rank's shard of ``t`` placed by spec ``s`` on ``mesh`` (a
    plain ``t`` is taken as replicated): the input side of a
    ``shard_map``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.utils.sharding import placements

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements(s, mesh)).to_local()


def from_local(t, s, mesh, shape=None):
    """The DTensor whose shard on this rank is ``t``, placed by spec
    ``s`` on ``mesh``, of global ``shape`` (default: ``t``'s, times the
    ranks of each axis ``s`` names, the shards being even): the output
    side of a ``shard_map``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.sharding import placements

    pl = placements(s, mesh)
    if shape is None:
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False)
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=tuple(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def placed(t, mesh):
    """{tensor dim: the mesh axes that shard it, in mesh order} of a
    DTensor."""
    out = {}
    for name, pl in zip(mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            out.setdefault(pl.dim, []).append(name)
    return out


def axes_of(e) -> tuple:
    """The mesh axes a spec entry names."""
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def entry(names):
    """A spec entry naming ``names`` (None, one axis or a tuple)."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def maybe_shard(x, *entries):
    """Under an active mesh, a DTensor ``x`` redistributed to the spec's
    placements; otherwise ``x``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.sharding import placements

    s = spec(*entries)
    if s is None or not isinstance(x, DTensor):
        return x
    mesh = active_mesh()
    pl = placements(_dividing(s, x.shape, mesh), mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def model_ways() -> int:
    """Ranks on the active mesh's ``model`` dim (1 off-mesh)."""
    mesh = active_mesh()
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return 1
    return mesh.size(list(mesh.mesh_dim_names).index(MODEL_AXIS))


def shard_batch_seq(x):
    """(B, S, d): batch over data axes, sequence over model (seq-parallel
    residual stream — DESIGN.md §5)."""
    return maybe_shard(x, DP_AXES, MODEL_AXIS, None)


def shard_batch(x):
    """(B, S, d): batch over data axes, the sequence gathered — the
    sequence-parallel all-gather before a column-parallel matmul.  JAX
    leaves it to XLA; DTensor has no matmul strategy for an activation
    whose two flattened dims are both sharded, so the port says it."""
    return maybe_shard(x, DP_AXES, None, None)


def shard_decode(x):
    """(B, 1, d) decode activations: batch over data axes only."""
    return maybe_shard(x, DP_AXES, None, None)


def shard_kv_cache(c, long_context: bool):
    """KV cache (B, T, K, D): heads over model; for long-context
    single-request decode the *sequence* is sharded over data
    (flash-decode style)."""
    if long_context:
        return maybe_shard(c, None, "data", MODEL_AXIS, None)
    return maybe_shard(c, DP_AXES, None, MODEL_AXIS, None)


# --------------------------------------------------------------------------
# explicit collectives over mesh dims (the port's shard_map bodies)
# --------------------------------------------------------------------------

def _group(mesh, axis: str):
    return (mesh, list(mesh.mesh_dim_names).index(axis))


class _PSum(torch.autograd.Function):
    """Sum over a mesh dim's ranks; its gradient, replicated like the sum,
    passes through unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(t, mesh, axes):
    """``t`` summed over the ranks of each mesh dim in ``axes`` (JAX's
    ``lax.psum``), differentiable."""
    for a in axes:
        t = _PSum.apply(t, _group(mesh, a))
    return t


def pmax(t, mesh, axes):
    """``t``'s elementwise max over the ranks of each mesh dim in
    ``axes``, with no gradient."""
    from torch.distributed import _functional_collectives as funcol

    t = t.detach()
    for a in axes:
        t = funcol.wait_tensor(funcol.all_reduce(t, "max",
                                                 _group(mesh, a)))
    return t
