"""Load the JAX package's parameters into the port's modules.

The JAX model's parameter pytree, with every leaf turned into a numpy
array (``jax.tree.map(np.asarray, params)`` on the JAX side), is nested
dicts and lists::

    embed (V, d)   final_norm {scale[, bias]}   [lm_head (d, V)]
    prefix: [block, ...]
    period: [stacked block, ...]   (every leaf has a leading n_rep axis)

:func:`params_from_numpy` unstacks ``period`` into the port's flat
per-layer list (layer ``prefix + r * period + j`` is entry ``j`` of the
period at index ``r``) and copies every leaf into an :class:`~repro_torch
.models.transformer.LM`, by name: a block's ``attn``/``mlp`` leaves, its
``mamba`` leaves (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``,
``D``, ``dt_bias``, ``norm_scale``, ``out_proj``) into the same-named
parameters of :class:`~repro_torch.models.ssm.Mamba`, or its ``moe``
leaves (``router``, ``w_gate``, ``w_up``, ``w_down`` and the shared
expert's ``shared.*``) into :class:`~repro_torch.models.moe.MoE`, each
cast to the parameter's dtype (JAX's fp32 masters become bf16 copies
where the port stores the model dtype; the router stays fp32, as JAX
reads it).

The encoder-decoder pytree (whisper) is ``embed``, ``dec_pos``,
``enc_final``, ``dec_final`` and the ``encoder`` / ``decoder`` blocks,
each stacked over its layers (JAX's ``vmap`` init): they are unstacked
into the two ``nn.ModuleList``s of an :class:`~repro_torch.models.encdec
.EncDec`.  :func:`numpy_from_params` is the inverse (the tests compare
trained parameters with JAX's through it, and the port's checkpoints
are written in JAX's key layout with it).  Nothing here imports JAX:
only numpy arrays cross.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype

from . import encdec, transformer


def flatten(tree, sep: str = ".", prefix: str = "") -> dict:
    """Nested dicts and lists of arrays -> {"a.b.0.c": array}: the keys
    on the path joined by ``sep``, a list's keys its indices (the port's
    parameter names with "."; JAX's checkpoint keys with "/")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(flatten(sub, sep, f"{prefix}{sep}{key}" if prefix
                           else str(key)))
    return out


def unflatten(flat: dict, sep: str = ".") -> dict:
    """The inverse of :func:`flatten`: a level whose keys are all digits
    becomes a list."""
    tree: dict = {}
    for name, arr in flat.items():
        *path, leaf = name.split(sep)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


def load_arrays(module, arrays: dict, where: str = "params") -> None:
    """Copy {parameter name: array} into ``module``'s same-named
    parameters, each cast to the parameter's dtype."""
    params = dict(module.named_parameters())
    for name, arr in arrays.items():
        dst = params.get(name)
        if dst is None:
            raise KeyError(f"{where}.{name}: no such parameter in the port")
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{where}.{name}: shape {arr.shape}, expected "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.tensor(arr))


def _load_module(module, tree: dict, where: str) -> None:
    """Copy the leaves of ``tree`` into the same-named attributes."""
    load_arrays(module, flatten(tree), where)


def named_arrays(cfg, tree: dict) -> dict:
    """JAX pytree of numpy arrays -> {the port's parameter name: array}:
    the stacked layers unstacked (``layers.{i}.…`` for a decoder,
    ``encoder.{i}.…`` / ``decoder.{i}.…`` for whisper)."""
    if cfg.is_encoder_decoder:
        stacks = ("encoder", "decoder")
        out = flatten({k: v for k, v in tree.items() if k not in stacks})
        for name, n_cfg in zip(stacks, (cfg.encoder_layers, cfg.num_layers)):
            n = len(np.asarray(tree[name]["norm1"]["scale"]))
            if n != n_cfg:
                raise ValueError(f"pytree holds {n} {name} layers, config "
                                 f"{n_cfg}")
            for i in range(n):
                out.update(flatten(_index(tree[name], i),
                                   prefix=f"{name}.{i}"))
        return out
    _, prefix_len, period, n_rep = transformer.structure(cfg)
    out = flatten({k: v for k, v in tree.items()
                   if k not in ("prefix", "period")})
    blocks = list(tree.get("prefix", []))   # an npz has no empty list
    for r in range(n_rep):
        for j in range(period):
            blocks.append(_index(tree["period"][j], r))
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"pytree holds {len(blocks)} layers, config "
                         f"{cfg.num_layers}")
    for i, block in enumerate(blocks):
        out.update(flatten(block, prefix=f"layers.{i}"))
    return out


def params_from_numpy(cfg, tree: dict, device=None, dtype=None):
    """JAX pytree of numpy arrays -> the port's :class:`LM` (or, for an
    encoder-decoder config, :class:`EncDec`) on ``device`` in ``dtype``
    (default ``cfg.dtype``; norm parameters stay fp32)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    init = encdec.init_encdec if cfg.is_encoder_decoder \
        else transformer.init_lm
    model = init(None, cfg, device, dtype)
    load_arrays(model, named_arrays(cfg, tree))
    return model


def _stack(trees: list):
    """Leafwise ``np.stack`` of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def numpy_from_params(cfg, params) -> dict:
    """The inverse of :func:`params_from_numpy`: an :class:`LM` /
    :class:`EncDec` (or a dict of parameter name -> tensor, such as the
    optimizer's masters or moments) -> the JAX package's pytree layout,
    every leaf a float32 numpy copy (JAX's masters are fp32; a bf16
    tensor is widened exactly).  A decoder's layers are stacked into
    ``prefix`` / ``period`` as ``transformer.structure`` splits them."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else dict(params))
    tree = unflatten({n: t.detach().to("cpu", torch.float32,
                                        copy=True).numpy()
                      for n, t in named.items()})
    if cfg.is_encoder_decoder:
        for name in ("encoder", "decoder"):
            tree[name] = _stack(tree[name])
        return tree
    _, prefix_len, period, n_rep = transformer.structure(cfg)
    blocks = tree.pop("layers")
    tree["prefix"] = blocks[:prefix_len]
    tree["period"] = [
        _stack([blocks[prefix_len + r * period + j] for r in range(n_rep)])
        for j in range(period)]
    return tree


def _index(tree, r: int):
    """Leaf ``[r]`` of every array in a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]
