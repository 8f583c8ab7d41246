"""Model registry: ModelConfig -> uniform training and serving API.

Port of ``repro.models.model``::

    api = build_model(cfg, device="cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = api.loss_fn(params, batch)                # train
    logits = api.prefill_fn(params, {"tokens": tokens})        # (B, V)
    caches = api.init_caches(batch, max_len)                  # dense
    caches = api.init_paged_caches(batch, num_blocks, block_size)
    logits, caches = api.decode_fn(params, caches, batch)

``api.input_specs(shape)`` returns fake-tensor stand-ins for the batch
of a given ``InputShape`` (the dry-run's contract) and
``api.batch_pspecs(shape)`` their partition specs, as JAX's do.
``build_model(..., distributed=True, mesh=mesh)`` routes MoE layers to
``moe_ep`` over ``mesh`` (JAX's ``_moe_impl_for``).

``build_model`` runs on ``cuda`` unless ``device="cpu"`` is passed, and
raises without a card.  It serves the decoder family: ``arch_type``
``dense``; ``vlm`` (Qwen2-VL: M-RoPE over ``(3, B, S)`` positions and
vision-patch embeddings prepended to the tokens, both from
:func:`stub_vision_frontend`, which ``prefill_fn`` and ``loss_fn`` take
as ``"frontend_embeds"`` and ``"positions3"``; ``decode_fn`` puts every
stream at ``cache_len`` unless given ``"positions3"`` (3, B, 1));
``moe`` (an MoE channel mix in the layers ``cfg.is_moe_layer`` names,
optionally with a shared expert, through ``moe_dense`` for up to 4
experts and ``moe_ragged`` on the ``branch_matmul`` kernel above that,
as :func:`_moe_impl_for` picks and JAX picks); ``ssm`` (mamba2: Mamba2
mixers with no channel mix, whose caches are per-row SSM state and conv
windows, on the dense and the paged path alike; ``prefill_fn`` needs S
to be a multiple of ``cfg.ssm.chunk``); and hybrids of the two mixers.
It serves the encoder-decoder family (whisper) through
:func:`_build_encdec`: ``prefill_fn`` takes ``{"frames": (B, S_enc,
d), "tokens": (B, 1)}`` (frames from :func:`stub_audio_frontend`),
dense caches only (``init_paged_caches`` is None).  Weights are stored
in ``cfg.dtype`` (or ``dtype``); norm parameters, the MoE router and
the SSM's ``A_log``, ``D`` and ``dt_bias`` stay fp32.  ``loss_fn`` takes
``{"tokens", "labels"}`` (and ``"frames"`` for whisper; Qwen2-VL's
frontend positions carry no loss, so its labels are the tokens', (B,
S_txt)) and returns ``(loss, {"ce", "aux"})`` (no ``"aux"`` for
whisper), differentiable with respect to the params once their
gradients are on (see :mod:`repro_torch.training`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.utils.sharding import P

from . import encdec, transformer
from .sharding import DP_AXES


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
    # (InputShape, fake_mode=None) -> dict[str, fake tensor]
    input_specs: "Callable | None" = None
    # (InputShape) -> dict[str, P]
    batch_pspecs: "Callable | None" = None
    # (batch, num_blocks, block_size, dtype) -> physically paged caches;
    # None for families without a paged decode path (encoder-decoder)
    init_paged_caches: "Callable | None" = None


def _moe_impl_for(cfg, distributed: bool):
    if cfg.moe.num_experts == 0:
        return "ragged"
    if not distributed:
        return "dense" if cfg.moe.num_experts <= 4 else "ragged"
    return "ep"


def _check_generator(gen, device):
    if gen is not None and gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")


def _stand_ins(fake_mode, shapes: dict) -> dict:
    """{name: (shape, dtype)} -> fake tensors of ``fake_mode`` (a fresh
    ``FakeTensorMode`` when None): JAX's ``ShapeDtypeStruct`` stand-ins."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_mode or FakeTensorMode():
        return {k: torch.empty(sh, dtype=dt) for k, (sh, dt) in
                shapes.items()}


def build_model(cfg, device=None, dtype=None, *, distributed=False,
                mesh=None) -> ModelAPI:
    """The model's API on ``device`` in ``dtype`` (default
    ``cfg.dtype``).  ``distributed`` routes MoE layers to ``moe_ep`` over
    ``mesh``.  JAX's ``long_context`` argument is left out: its build
    never reads it (the long-context cache layout is the dry-run's
    ``cache_pspecs``)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    if cfg.is_encoder_decoder:
        return _build_encdec(cfg, device, dtype)
    moe_impl = _moe_impl_for(cfg, distributed)
    is_vlm = cfg.frontend == "vision_patches"
    n_front = cfg.num_frontend_tokens if is_vlm else 0
    idt = torch.int32

    def init(gen):
        _check_generator(gen, device)
        return transformer.init_lm(gen, cfg, device, dtype)

    def optional(batch, key):
        t = batch.get(key)
        return None if t is None else torch.as_tensor(t, device=device)

    def loss_fn(params, batch):
        return transformer.lm_loss(
            params, cfg, torch.as_tensor(batch["tokens"], device=device),
            torch.as_tensor(batch["labels"], device=device),
            optional(batch, "frontend_embeds"), optional(batch, "positions3"),
            moe_impl=moe_impl, mesh=mesh)

    def prefill_fn(params, batch):
        return transformer.prefill_lm(
            params, cfg, torch.as_tensor(batch["tokens"], device=device),
            optional(batch, "frontend_embeds"), optional(batch, "positions3"),
            moe_impl=moe_impl, mesh=mesh)

    def decode_fn(params, caches, batch):
        return transformer.decode_lm(
            params, cfg, caches, batch["tokens"], batch["cache_len"],
            active=batch.get("active"),
            block_tables=batch.get("block_tables"), moe_impl=moe_impl,
            positions3=batch.get("positions3"), mesh=mesh)

    def init_caches(batch, max_len, cache_dtype=None, ring=False,
                    tile=16):
        return transformer.init_caches(
            cfg, batch, max_len, torch_dtype(cache_dtype or dtype), device,
            ring, tile)

    def init_paged_caches(batch, num_blocks, block_size, cache_dtype=None):
        return transformer.init_paged_caches(
            cfg, batch, num_blocks, block_size,
            torch_dtype(cache_dtype or dtype), device)

    def input_specs(shape, fake_mode=None):
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":      # one token against a seq_len cache
            sp = {"tokens": ((B, 1), idt), "cache_len": ((), idt)}
            if is_vlm:
                sp["positions3"] = ((3, B, 1), idt)
            return _stand_ins(fake_mode, sp)
        txt = S - n_front
        sp = {"tokens": ((B, txt), idt)}
        if shape.kind == "train":
            sp["labels"] = ((B, txt), idt)
        if is_vlm:
            sp["frontend_embeds"] = ((B, n_front, cfg.d_model), dtype)
            sp["positions3"] = ((3, B, S), idt)
        return _stand_ins(fake_mode, sp)

    def batch_pspecs(shape):
        dp = DP_AXES
        if shape.kind == "decode":
            rows = dp if shape.global_batch > 1 else None
            sp = {"tokens": P(rows, None), "cache_len": P()}
            if is_vlm:
                sp["positions3"] = P(None, rows, None)
            return sp
        sp = {"tokens": P(dp, None)}
        if shape.kind == "train":
            sp["labels"] = P(dp, None)
        if is_vlm:
            sp["frontend_embeds"] = P(dp, None, None)
            sp["positions3"] = P(None, dp, None)
        return sp

    return ModelAPI(cfg, device, dtype, init, loss_fn, prefill_fn,
                    decode_fn, init_caches, input_specs, batch_pspecs,
                    init_paged_caches)


# --------------------------------------------------------------------------
# encoder-decoder family (whisper)
# --------------------------------------------------------------------------

DEC_LEN = 448                      # whisper decoder context


def _build_encdec(cfg, device, dtype) -> ModelAPI:
    """``prefill_fn`` = the encoder, the cross K/V and the first decoder
    token (``batch["tokens"][:, :1]`` at position 0) on fresh caches of
    ``DEC_LEN`` slots, which it drops, returning (B, V) logits, as JAX's
    does; a decode loop calls ``encdec.prefill_encdec`` on caches of its
    own, then ``decode_fn``.  No paged path (JAX has none)."""

    def init(gen):
        _check_generator(gen, device)
        return encdec.init_encdec(gen, cfg, device, dtype)

    def loss_fn(params, batch):
        return encdec.encdec_loss(
            params, cfg, torch.as_tensor(batch["frames"], device=device),
            torch.as_tensor(batch["tokens"], device=device),
            torch.as_tensor(batch["labels"], device=device))

    def prefill_fn(params, batch):
        frames = torch.as_tensor(batch["frames"], device=device)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        caches = encdec.place_caches(encdec.init_dec_caches(
            cfg, frames.shape[0], DEC_LEN, dtype, device), frames)
        _, caches = encdec.prefill_encdec(params, cfg, frames, caches)
        logits, _ = encdec.decode_step_encdec(params, cfg, caches,
                                              tokens[:, :1], 0)
        return logits

    def decode_fn(params, caches, batch):
        return encdec.decode_step_encdec(
            params, cfg, caches, batch["tokens"], batch["cache_len"],
            active=batch.get("active"))

    def init_caches(batch, max_len, cache_dtype=None, ring=False,
                    tile=16):
        del ring
        return encdec.init_dec_caches(
            cfg, batch, max_len, torch_dtype(cache_dtype or dtype), device,
            tile)

    idt = torch.int32

    def input_specs(shape, fake_mode=None):
        # the encoder carries the assigned seq_len (frame embeddings from
        # the stub frontend); the decoder uses Whisper's native context
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            sp = {"frames": ((B, S, cfg.d_model), dtype),
                  "tokens": ((B, DEC_LEN), idt),
                  "labels": ((B, DEC_LEN), idt)}
        elif shape.kind == "prefill":
            sp = {"frames": ((B, S, cfg.d_model), dtype),
                  "tokens": ((B, 1), idt)}
        else:
            sp = {"tokens": ((B, 1), idt), "cache_len": ((), idt)}
        return _stand_ins(fake_mode, sp)

    def batch_pspecs(shape):
        dp = DP_AXES
        if shape.kind == "train":
            return {"frames": P(dp, None, None), "tokens": P(dp, None),
                    "labels": P(dp, None)}
        if shape.kind == "prefill":
            return {"frames": P(dp, None, None), "tokens": P(dp, None)}
        return {"tokens": P(dp, None), "cache_len": P()}

    return ModelAPI(cfg, device, dtype, init, loss_fn, prefill_fn,
                    decode_fn, init_caches, input_specs, batch_pspecs)


# --------------------------------------------------------------------------
# frontend stubs (smoke tests / examples need concrete inputs)
# --------------------------------------------------------------------------

def stub_vision_frontend(gen, cfg, batch, total_seq):
    """Vision-patch embeddings and M-RoPE 3-stream positions (Qwen2-VL).

    Returns ``(embeds (batch, n, d), positions3 (3, batch, total_seq))``
    with n = ``cfg.num_frontend_tokens``: the embeddings N(0, 1) * 0.02
    in the model dtype, drawn from ``gen`` on its device; the positions
    int32 on the same device, JAX's integers: the patches on a square
    grid (t = 0, h = i // side, w = i % side), the text tokens at equal
    (t, h, w) ids continuing after the grid, a faithful simplification
    of dynamic-resolution M-RoPE.  JAX's draw cannot be reproduced, so
    the tests carry JAX's embeddings across as numpy."""
    n = cfg.num_frontend_tokens
    emb = torch.randn((batch, n, cfg.d_model), generator=gen,
                      device=gen.device) * 0.02
    side = max(1, int(np.sqrt(n)))
    t = np.zeros(n, np.int32)
    h = (np.arange(n) // side).astype(np.int32)
    w = (np.arange(n) % side).astype(np.int32)
    text = np.arange(total_seq - n, dtype=np.int32) + h.max() + 1
    pos3 = np.stack([np.concatenate([t, text]),
                     np.concatenate([h, text]),
                     np.concatenate([w, text])])
    pos3 = np.broadcast_to(pos3[:, None, :], (3, batch, total_seq))
    return (emb.to(torch_dtype(cfg.dtype)),
            torch.tensor(pos3, device=gen.device))


def stub_audio_frontend(gen, cfg, batch, n_frames):
    """Mel+conv frontend stub: precomputed frame embeddings (batch,
    n_frames, d), N(0, 1) * 0.02 in the model dtype, on ``gen``'s
    device."""
    x = torch.randn((batch, n_frames, cfg.d_model), generator=gen,
                    device=gen.device) * 0.02
    return x.to(torch_dtype(cfg.dtype))
