"""Model registry: ModelConfig -> uniform serving API.

Port of ``repro.models.model`` for the decoder family::

    api = build_model(cfg, device="cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    logits = api.prefill_fn(params, {"tokens": tokens})        # (B, V)
    caches = api.init_caches(batch, max_len)                  # dense
    caches = api.init_paged_caches(batch, num_blocks, block_size)
    logits, caches = api.decode_fn(params, caches, batch)

``build_model`` runs on ``cuda`` unless ``device="cpu"`` is passed, and
raises without a card.  It serves the decoder family: ``arch_type``
``dense``, ``moe`` (an MoE channel mix in the layers ``cfg.is_moe_layer``
names, optionally with a shared expert, through ``moe_dense`` for up to
4 experts and ``moe_ragged`` on the ``branch_matmul`` kernel above that,
as :func:`_moe_impl_for` picks and JAX picks) and ``ssm`` (mamba2:
Mamba2 mixers with no channel mix, whose caches are per-row SSM state
and conv windows, on the dense and the paged path alike;
``prefill_fn`` needs S to be a multiple of ``cfg.ssm.chunk``), and
hybrids of the two mixers.  Weights are stored in ``cfg.dtype`` (or
``dtype``); norm parameters, the MoE router and the SSM's ``A_log``,
``D`` and ``dt_bias`` stay fp32.  ``loss_fn`` arrives with the training
slice, encoder-decoder models with the Whisper slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device, torch_dtype

from . import transformer


@dataclass
class ModelAPI:
    cfg: Any
    device: torch.device
    dtype: torch.dtype
    init: Callable                 # (torch.Generator) -> params
    loss_fn: Callable              # (params, batch) -> (loss, metrics)
    prefill_fn: Callable           # (params, batch) -> (B, V) logits
    decode_fn: Callable            # (params, caches, batch) -> (logits, caches)
    # (batch, max_len, dtype, ring, tile) -> dense per-row caches
    init_caches: Callable
    # (batch, num_blocks, block_size, dtype) -> physically paged caches
    init_paged_caches: Callable


def _moe_impl_for(cfg, distributed: bool):
    if cfg.moe.num_experts == 0:
        return "ragged"
    if not distributed:
        return "dense" if cfg.moe.num_experts <= 4 else "ragged"
    return "ep"


def build_model(cfg, device=None, dtype=None) -> ModelAPI:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "encoder-decoder models arrive with the Whisper slice")
    moe_impl = _moe_impl_for(cfg, distributed=False)
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)

    def init(gen):
        if gen is not None and gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{device}")
        return transformer.init_lm(gen, cfg, device, dtype)

    def loss_fn(params, batch):
        raise NotImplementedError(
            "loss_fn arrives with the training slice")

    def prefill_fn(params, batch):
        return transformer.prefill_lm(
            params, cfg, torch.as_tensor(batch["tokens"], device=device),
            batch.get("frontend_embeds"), batch.get("positions3"),
            moe_impl=moe_impl)

    def decode_fn(params, caches, batch):
        return transformer.decode_lm(
            params, cfg, caches, batch["tokens"], batch["cache_len"],
            active=batch.get("active"),
            block_tables=batch.get("block_tables"), moe_impl=moe_impl)

    def init_caches(batch, max_len, cache_dtype=None, ring=False,
                    tile=16):
        return transformer.init_caches(
            cfg, batch, max_len, torch_dtype(cache_dtype or dtype), device,
            ring, tile)

    def init_paged_caches(batch, num_blocks, block_size, cache_dtype=None):
        return transformer.init_paged_caches(
            cfg, batch, num_blocks, block_size,
            torch_dtype(cache_dtype or dtype), device)

    return ModelAPI(cfg, device, dtype, init, loss_fn, prefill_fn,
                    decode_fn, init_caches, init_paged_caches)
