"""Parameter sharding rules (FSDP + tensor parallelism) and their DTensor
placements.

Port of ``repro.utils.sharding``.  Rules are keyed on the *leaf name* of
a parameter, the last component of its name in the port's ``nn.Module``
tree (``wq``, ``w_down``, ``embed``...), and are written over two
logical groups:

* ``FSDP`` — fully-sharded data-parallel axes: ``("pod", "data")`` on
  the multi-pod mesh, ``("data",)`` single-pod,
* ``TP`` — the tensor/model parallel axis ``"model"`` (also the
  expert-parallel dim of the MoE weights).

Rules match from the trailing dims.  JAX stacks layers under leading
scan dims, which its rules pad with ``None``; the port keeps one module
per layer, so its leaves carry no such dims.  MoE expert tensors are
recognised by a ``moe`` component in the name, as in JAX, and by their
three dims: a shared expert's 2-D weights take the dense rules.  (JAX's
stacked shared expert has three dims and falls under the expert rule by
arity; the port's does not.)

Specs are :class:`P` tuples: one entry per tensor dim, each ``None``, a
mesh axis name or a tuple of names (major to minor).  :func:`placements`
turns one into DTensor placements over a ``DeviceMesh``, and
:func:`distribute` builds the DTensor of a tensor's local shard.  A mesh
here is a ``DeviceMesh`` or a ``{axis name: size}`` dict (an abstract
mesh, as the tests and the spec comparisons use).
"""

from __future__ import annotations

import torch
from torch import nn

FSDP = "__fsdp__"
TP = "model"


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# trailing-dims spec per leaf name
_RULES = {
    # embeddings / vocab
    "embed": (TP, FSDP),
    "lm_head": (FSDP, TP),
    "dec_pos": (None, FSDP),
    # attention
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
    "wo": (TP, FSDP),
    "bq": (TP,), "bk": (TP,), "bv": (TP,),
    # dense mlp
    "w_gate": (FSDP, TP), "w_up": (FSDP, TP), "w_down": (TP, FSDP),
    "b_up": (TP,), "b_down": (None,),
    # moe (3D expert weights override the 2D mlp names by arity)
    "router": (FSDP, None),
    # mamba
    "in_proj": (FSDP, TP), "out_proj": (TP, FSDP),
    "conv_w": (None, TP), "conv_b": (TP,),
    "A_log": (TP,), "D": (TP,), "dt_bias": (TP,),
    "norm_scale": (None,),
    # norms
    "scale": (None,), "bias": (None,),
}

# MoE expert tensors are 3D (E, d, f) / (E, f, d): experts over TP,
# feature FSDP.
_MOE_RULES = {
    "w_gate": (TP, FSDP, None),
    "w_up": (TP, FSDP, None),
    "w_down": (TP, None, FSDP),
}


def axis_sizes(mesh) -> "dict[str, int]":
    """{axis name: size} of a ``DeviceMesh`` or of a dict standing for
    one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _prod(it):
    out = 1
    for v in it:
        out *= v
    return out


def _resolve(entry, dim, mesh_axes, axis_sizes, fsdp_axes):
    """Resolve one rule entry against the mesh, dropping axes that do not
    divide the dimension (e.g. vocab 51865 on a 16-way axis -> replicate,
    the standard fallback when a framework chooses not to pad)."""
    if entry is None:
        return None
    if entry == FSDP:
        sub = []
        for a in fsdp_axes:
            if a in mesh_axes and dim % (axis_sizes[a]
                                         * _prod(axis_sizes[x]
                                                 for x in sub)) == 0:
                sub.append(a)
        if not sub:
            return None
        return tuple(sub) if len(sub) > 1 else sub[0]
    if entry in mesh_axes and dim % axis_sizes[entry] == 0:
        return entry
    return None


def _in_moe(name: str) -> bool:
    return "moe" in name.split(".")


def spec_for(name: str, shape, mesh_axes, axis_sizes=None,
             fsdp_axes=("pod", "data")) -> P:
    """The spec of the parameter called ``name`` (dotted, as
    ``named_parameters`` gives it) of this ``shape``."""
    leaf = name.split(".")[-1]
    ndim = len(shape)
    axis_sizes = axis_sizes or {a: 1 for a in mesh_axes}
    rule = None
    if leaf in _MOE_RULES and ndim >= 3 and _in_moe(name):
        rule = _MOE_RULES[leaf]
    if rule is None:
        rule = _RULES.get(leaf)
    if rule is None:
        return P()                                     # replicate unknowns
    rule = tuple(rule)
    if len(rule) > ndim:                               # scalar-ish leaf
        rule = rule[-ndim:] if ndim else ()
    pad = (None,) * (ndim - len(rule))
    dims = tuple(shape)[ndim - len(rule):]
    entries = pad + tuple(
        _resolve(e, d, mesh_axes, axis_sizes, fsdp_axes)
        for e, d in zip(rule, dims))
    return P(*entries)


def named(params) -> "dict[str, torch.Tensor]":
    """An ``nn.Module``'s named parameters, or a name -> tensor dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_pspecs(params, mesh) -> "dict[str, P]":
    """{parameter name: spec} for ``params``."""
    sizes = axis_sizes(mesh)
    return {n: spec_for(n, t.shape, tuple(sizes), sizes)
            for n, t in named(params).items()}


def inference_param_pspecs(params, mesh) -> "dict[str, P]":
    """Serving-time parameter layout (§Perf optimization O2').

    Differs from the training layout in the MoE experts: expert dim over
    'model' AND the FFN hidden dim over the data axes — matching the
    decode-regime EP (moe._moe_ep_replicated), which computes partial
    FFN slices in place and all-reduces (T, d) outputs.  No expert weight
    is ever gathered.
    """
    sizes = axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = _prod(sizes[a] for a in data_axes)
    f_entry = data_axes if len(data_axes) > 1 else (
        data_axes[0] if data_axes else None)
    out = param_pspecs(params, mesh)
    for name, t in named(params).items():
        leaf = name.split(".")[-1]
        if not (_in_moe(name) and leaf in _MOE_RULES and t.ndim >= 3):
            continue
        pad = (None,) * (t.ndim - 3)
        e_ax = "model" if ("model" in sizes
                           and t.shape[-3] % sizes["model"] == 0) else None
        # f dim: -1 for w_gate/w_up (E,d,f), -2 for w_down (E,f,d)
        f_dim = -1 if leaf in ("w_gate", "w_up") else -2
        fe = f_entry if t.shape[f_dim] % max(n_data, 1) == 0 else None
        out[name] = (P(*(pad + (e_ax, None, fe))) if f_dim == -1
                     else P(*(pad + (e_ax, fe, None))))
    return out


def opt_state_pspecs(opt_state, params_pspecs) -> dict:
    """The port's optimizer state: the fp32 masters, m and v mirror the
    parameter specs; step is replicated."""
    del opt_state
    return {"master": params_pspecs, "m": params_pspecs,
            "v": params_pspecs, "step": P()}


def cast_abstract_params(params, dtype) -> nn.Module:
    """Every floating parameter of the module cast to ``dtype`` in place
    (bf16 serving checkpoints, §Perf optimization O1); returns it."""
    for name, p in list(params.named_parameters()):
        if p.dtype.is_floating_point and p.dtype != dtype:
            _set(params, name, nn.Parameter(p.detach().to(dtype),
                                            requires_grad=False))
    return params


def tree_bytes(tree) -> int:
    """Bytes of every tensor in nested dicts / lists / a module (a
    DTensor counts its global size)."""
    if isinstance(tree, nn.Module):
        tree = named(tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(t) for t in tree)
    return 0


def abstract_params(api, fake_mode):
    """The model's parameters as fake tensors of ``fake_mode`` (shapes and
    dtypes, no storage): JAX's ``eval_shape`` of ``api.init``."""
    with fake_mode:
        return api.init(None)


# --------------------------------------------------------------------------
# specs -> DTensor
# --------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d names the mesh dim, else
    ``Replicate()`` (also on a mesh dim of size 1, where DTensor's view
    rules would refuse a reshape of the dim for nothing).  A tensor dim
    named by several mesh dims is split
    major to minor in the order of the spec's tuple (JAX's order);
    DTensor splits a dim shared by several mesh dims in mesh-dim order,
    so the tuple must list them in the mesh's order, which every rule
    here does (``("pod", "data")``, ``("data", "model")``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if mesh.shape[i] > 1:   # a size-1 mesh dim splits nothing
                out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one rank's shard (every named axis divides its dim)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = _prod(sizes[a] for a in axes if a in sizes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out[d] //= n
    return tuple(out)


def distribute(t: torch.Tensor, spec: P, mesh):
    """A DTensor of ``t``'s global shape placed by ``spec``, built from
    this rank's shard and no collective: on a fake mesh the shard is a
    fresh tensor of the shard's shape (fake tensors hold no values), on a
    real one the rank's slice of ``t``."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    shape = local_shape(t.shape, spec, mesh)
    if shape == tuple(t.shape):
        local = t
    elif _is_fake(t):
        local = t.new_empty(shape)
    else:
        local = t
        coord = mesh.get_coordinate()
        sizes = axis_sizes(mesh)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = 0
            for a in axes:               # major to minor
                i = list(mesh.mesh_dim_names).index(a)
                idx = idx * sizes[a] + coord[i]
            local = local.narrow(d, idx * shape[d], shape[d])
        local = local.contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=_contiguous(t.shape))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _set(module: nn.Module, name: str, value) -> None:
    *path, leaf = name.split(".")
    for key in path:
        module = getattr(module, key)
    module._parameters[leaf] = value


def shard_module(params: nn.Module, specs: "dict[str, P]", mesh):
    """Every parameter of ``params`` replaced in place by its DTensor,
    placed by ``specs``; returns the module."""
    for name, p in list(params.named_parameters()):
        _set(params, name, nn.Parameter(distribute(p.detach(), specs[name],
                                                   mesh),
                                        requires_grad=False))
    return params
