"""The served model as the benchmark describes it: the layer plan and
the weights from the seed.

A configuration file (``configs/<name>.json``) holds the published keys
of its source, the keys ``reduced`` from it, the sizes ``assumed``, and
under ``"run"`` the model as it is run: the port's ``ModelConfig``
fields.  The layer plan, the weight layout and the weights themselves
are worked out here from ``"run"`` alone, so the reference
(:mod:`reference.model`) and the program get the same weights without
the reference reading anything the program made.

Weights are drawn on the device from the seed, layer by layer: every
random leaf of a layer in the served dtype comes from one ``normal_``
call over one flat buffer (fp32 leaves from a second), scaled per leaf;
constants are filled.  Layer ``i`` uses a generator seeded by ``(seed,
i + 1)`` (the embedding, final norm and head by ``(seed, 0)``), so any
layer can be drawn again alone, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@dataclass(frozen=True)
class Leaf:
    path: str            # attribute path under the layer (or the model)
    shape: tuple
    fp32: bool           # kept in fp32 whatever the served dtype
    init: str            # fan_in | embed | conv | ones | zeros | a_log


class Dims:
    """Widths and the layer plan of a ``"run"`` block."""

    def __init__(self, run: dict):
        self.run = run
        self.d = run["d_model"]
        self.H = run["num_heads"]
        self.K = run["num_kv_heads"]
        self.D = run.get("head_dim") or self.d // max(self.H, 1)
        self.V = run["vocab_size"]
        self.L = run["num_layers"]
        self.d_ff = run.get("d_ff", 0)
        self.theta = float(run.get("rope_theta", 1e4))
        moe = run.get("moe", {})
        self.E = moe.get("num_experts", 0)
        self.k = moe.get("num_experts_per_tok", 0)
        self.f = moe.get("d_ff_expert", 0)
        self.moe_freq = moe.get("layer_freq", 1)
        self.moe_offset = moe.get("layer_offset", 0)
        ssm = run.get("ssm", {})
        self.N = ssm.get("d_state", 0)
        self.P = ssm.get("head_dim", 64)
        self.expand = ssm.get("expand", 2)
        self.chunk = ssm.get("chunk", 64)
        self.Kw = ssm.get("conv_width", 4)
        self.G = ssm.get("n_groups", 1)
        self.di = self.expand * self.d
        self.Hm = self.di // self.P if self.N else 0
        self.conv_dim = self.di + 2 * self.G * self.N
        self.dtype = DTYPES[run.get("dtype", "bfloat16")]
        if run.get("norm_type", "rmsnorm") != "rmsnorm" \
                or run.get("tie_embeddings") or run.get("qkv_bias") \
                or run.get("sliding_window") \
                or moe.get("num_shared_experts", 0):
            raise ValueError("the benchmark's reference covers untied "
                             "RMSNorm decoders without QKV bias, window "
                             "or shared expert")

    def mixer(self, i: int) -> str:
        if self.run["arch_type"] == "ssm":
            return "mamba"
        period = self.run.get("attn_period", 0)
        if period <= 0:
            return "attn"
        return "attn" if i % period == self.run.get("attn_offset", 0) \
            else "mamba"

    def channel(self, i: int) -> str:
        if self.E and i >= self.moe_offset \
                and (i - self.moe_offset) % self.moe_freq == 0:
            return "moe"
        return "dense" if self.d_ff else "none"

    def plan(self) -> "list[tuple[str, str]]":
        return [(self.mixer(i), self.channel(i)) for i in range(self.L)]


def global_leaves(dm: Dims) -> "list[Leaf]":
    return [Leaf("embed", (dm.V, dm.d), False, "embed"),
            Leaf("final_norm.scale", (dm.d,), True, "ones"),
            Leaf("lm_head", (dm.d, dm.V), False, "embed")]


def layer_leaves(dm: Dims, i: int) -> "list[Leaf]":
    mixer, channel = dm.mixer(i), dm.channel(i)
    d = dm.d
    out = [Leaf("norm1.scale", (d,), True, "ones")]
    if mixer == "attn":
        out += [Leaf("attn.wq", (d, dm.H * dm.D), False, "fan_in"),
                Leaf("attn.wk", (d, dm.K * dm.D), False, "fan_in"),
                Leaf("attn.wv", (d, dm.K * dm.D), False, "fan_in"),
                Leaf("attn.wo", (dm.H * dm.D, d), False, "fan_in")]
    else:
        proj = 2 * dm.di + 2 * dm.G * dm.N + dm.Hm
        out += [Leaf("mamba.in_proj", (d, proj), False, "fan_in"),
                Leaf("mamba.conv_w", (dm.Kw, dm.conv_dim), False, "conv"),
                Leaf("mamba.conv_b", (dm.conv_dim,), False, "zeros"),
                Leaf("mamba.A_log", (dm.Hm,), True, "a_log"),
                Leaf("mamba.D", (dm.Hm,), True, "ones"),
                Leaf("mamba.dt_bias", (dm.Hm,), True, "zeros"),
                Leaf("mamba.norm_scale", (dm.di,), True, "ones"),
                Leaf("mamba.out_proj", (dm.di, d), False, "fan_in")]
    if channel != "none":
        out.append(Leaf("norm2.scale", (d,), True, "ones"))
    if channel == "moe":
        out += [Leaf("moe.router", (d, dm.E), True, "fan_in"),
                Leaf("moe.w_gate", (dm.E, d, dm.f), False, "fan_in"),
                Leaf("moe.w_up", (dm.E, d, dm.f), False, "fan_in"),
                Leaf("moe.w_down", (dm.E, dm.f, d), False, "fan_in")]
    elif channel == "dense":
        out += [Leaf("mlp.w_gate", (d, dm.d_ff), False, "fan_in"),
                Leaf("mlp.w_up", (d, dm.d_ff), False, "fan_in"),
                Leaf("mlp.w_down", (dm.d_ff, d), False, "fan_in")]
    return out


def _scale(leaf: Leaf) -> float:
    if leaf.init == "embed":
        return 0.02
    fan_in = leaf.shape[-2] if len(leaf.shape) > 1 else leaf.shape[0]
    s = 1.0 / math.sqrt(fan_in)
    return 0.1 * s if leaf.init == "conv" else s


def make(leaves: "list[Leaf]", seed: int, index: int, dtype,
         device) -> "dict[str, torch.Tensor]":
    """The leaves of one generator stream (``index`` 0: the globals,
    ``i + 1``: layer i), random ones from one flat buffer per dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) % (1 << 40)) * 4096 + index)
    out = {}
    for fp32 in (False, True):
        dt = torch.float32 if fp32 else dtype
        rand = [lf for lf in leaves if lf.fp32 == fp32
                and lf.init in ("fan_in", "embed", "conv")]
        n = sum(math.prod(lf.shape) for lf in rand)
        if n:
            flat = torch.empty(n, dtype=dt, device=device)
            flat.normal_(generator=gen)
            off = 0
            for lf in rand:
                size = math.prod(lf.shape)
                out[lf.path] = flat[off:off + size].view(lf.shape) \
                    .mul_(_scale(lf))
                off += size
        for lf in leaves:
            if lf.fp32 != fp32 or lf.path in out:
                continue
            if lf.init == "ones":
                out[lf.path] = torch.ones(lf.shape, dtype=dt, device=device)
            elif lf.init == "zeros":
                out[lf.path] = torch.zeros(lf.shape, dtype=dt,
                                           device=device)
            elif lf.init == "a_log":
                out[lf.path] = torch.log(torch.linspace(
                    1.0, 16.0, lf.shape[0], dtype=dt, device=device))
            else:
                raise ValueError(f"{lf.path}: init {lf.init}")
    return out


def globals_of(dm: Dims, seed: int, device) -> dict:
    return make(global_leaves(dm), seed, 0, dm.dtype, device)


def layer_of(dm: Dims, seed: int, i: int, device) -> dict:
    return make(layer_leaves(dm, i), seed, i + 1, dm.dtype, device)


def _attr(root, path: str):
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def fill(params, dm: Dims, seed: int, device) -> None:
    """Copy the seed's weights into the port's parameters in place
    (layer by layer, so one layer's draw is alive at a time)."""
    with torch.no_grad():
        for path, t in globals_of(dm, seed, device).items():
            _attr(params, path).copy_(_checked(params, path, t))
        for i in range(dm.L):
            layer = params.layers[i]
            for path, t in layer_of(dm, seed, i, device).items():
                _attr(layer, path).copy_(_checked(layer, path, t))
            del t


def _checked(root, path, t):
    p = _attr(root, path)
    if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
        raise ValueError(f"{path}: the port holds {tuple(p.shape)} "
                         f"{p.dtype}, the benchmark draws "
                         f"{tuple(t.shape)} {t.dtype}")
    return t
