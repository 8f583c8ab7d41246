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
.models.transformer.LM`, by name: a block's ``attn``/``mlp`` leaves, or
its ``mamba`` leaves (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``,
``D``, ``dt_bias``, ``norm_scale``, ``out_proj``) into the same-named
parameters of :class:`~repro_torch.models.ssm.Mamba`, each cast to the
parameter's dtype (JAX's fp32 masters become bf16 copies where the port
stores the model dtype).  Nothing here imports JAX: only numpy arrays
cross.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype

from . import transformer


def _copy(dst: torch.nn.Parameter, arr, where: str) -> None:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {arr.shape}, expected "
                         f"{tuple(dst.shape)}")
    dst.data.copy_(torch.tensor(arr))


def _load_module(module, tree: dict, where: str) -> None:
    """Copy the leaves of ``tree`` into the same-named attributes."""
    for name, leaf in tree.items():
        dst = getattr(module, name, None)
        if dst is None:
            raise KeyError(f"{where}.{name}: no such parameter in the port")
        if isinstance(leaf, dict):
            _load_module(dst, leaf, f"{where}.{name}")
        else:
            _copy(dst, leaf, f"{where}.{name}")


def params_from_numpy(cfg, tree: dict, device=None, dtype=None):
    """JAX pytree of numpy arrays -> the port's :class:`LM` on ``device``
    in ``dtype`` (default ``cfg.dtype``; norm parameters stay fp32)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    lm = transformer.init_lm(None, cfg, device, dtype)
    _, prefix_len, period, n_rep = transformer.structure(cfg)
    top = {k: v for k, v in tree.items() if k not in ("prefix", "period")}
    _load_module(lm, top, "params")
    blocks = list(tree["prefix"])
    for r in range(n_rep):
        for j in range(period):
            blocks.append(_index(tree["period"][j], r))
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"pytree holds {len(blocks)} layers, config "
                         f"{cfg.num_layers}")
    for i, (layer, block) in enumerate(zip(lm.layers, blocks)):
        _load_module(layer, block, f"layers[{i}]")
    return lm


def _index(tree, r: int):
    """Leaf ``[r]`` of every array in a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]
