"""npz checkpoints in the JAX package's key layout.

Port of ``repro.training.checkpoint``.  The JAX package saves each
pytree (params, optimizer state) as one npz whose keys are the
``"/"``-joined pytree paths, bf16 leaves widened to fp32, beside a
``meta.json``.  The port writes the same files with the same keys
(``models.bridge.numpy_from_params`` gives the pytree): ``params.npz``
holds the fp32 masters when an optimizer state is given (JAX saves its
fp32 params), else the module's values widened; ``opt_state.npz`` holds
``m/…``, ``v/…`` and ``step``.  A checkpoint written by either package
restores in the other.

Restoring writes into the given module and optimizer state in place:
the params rounded to each parameter's dtype, the masters at full fp32,
the moments cast to their dtype.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.models.bridge import (flatten, load_arrays, named_arrays,
                                       numpy_from_params, unflatten)


def save_checkpoint(path, cfg, params, opt_state=None, step: int = 0,
                    metadata: "dict | None" = None) -> None:
    """Write ``params.npz`` (the masters when ``opt_state`` is given),
    ``opt_state.npz`` and ``meta.json`` under ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    masters = params if opt_state is None else opt_state["master"]
    np.savez(path / "params.npz",
             **flatten(numpy_from_params(cfg, masters), "/"))
    if opt_state is not None:
        opt = {"m": numpy_from_params(cfg, opt_state["m"]),
               "v": numpy_from_params(cfg, opt_state["v"]),
               "step": np.asarray(int(opt_state["step"]), np.int32)}
        np.savez(path / "opt_state.npz", **flatten(opt, "/"))
    meta = {"step": step, **(metadata or {})}
    (path / "meta.json").write_text(json.dumps(meta, indent=2))


def _named(cfg, npz_file, prefix: str = "") -> dict:
    """One tree of an npz (the keys under ``prefix``) -> {port name:
    array}."""
    with np.load(npz_file) as data:
        flat = {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}
    return named_arrays(cfg, unflatten(flat, "/"))


def load_checkpoint(path, cfg, params, opt_state=None):
    """Restore ``path`` into ``params`` (a module) and, when given and
    saved, ``opt_state`` (from ``init_opt_state``), in place.  Returns
    (params, opt_state, meta)."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    arrays = _named(cfg, path / "params.npz")
    load_arrays(params, arrays)
    if opt_state is not None and (path / "opt_state.npz").exists():
        with torch.no_grad():
            for name, arr in arrays.items():
                opt_state["master"][name].copy_(torch.from_numpy(arr))
            for k in ("m", "v"):
                for name, arr in _named(cfg, path / "opt_state.npz",
                                        f"{k}/").items():
                    opt_state[k][name].copy_(torch.from_numpy(arr))
            with np.load(path / "opt_state.npz") as data:
                step = int(data["step"])
        opt_state["step"] = torch.tensor(
            step, dtype=torch.int32, device=opt_state["step"].device)
    return params, opt_state, meta
