"""Model / run configuration schema.

One :class:`ModelConfig` per assigned architecture lives in
``src/repro_torch/configs/<arch>.py`` with the exact public-literature
hyper-parameters (source cited in ``source``).  ``reduced()`` derives the
CPU-smoke variant (<= 2 layers, d_model <= 512, <= 4 experts) mandated for
the per-arch smoke tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_ff_expert: int = 0           # per-expert hidden dim
    layer_freq: int = 1            # every n-th block is MoE (jamba: 2)
    layer_offset: int = 0          # first MoE block index
    capacity_factor: float = 1.25  # EP dispatch capacity
    num_shared_experts: int = 0    # always-active shared expert (Kimi K2)
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01  # load-balance loss (Switch-style)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0
    head_dim: int = 64             # P in SSD
    expand: int = 2
    chunk: int = 64                # SSD chunk length
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free layers
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 -> full attention
    rope_theta: float = 1e4
    mrope_sections: tuple = ()     # e.g. (16, 24, 24) for Qwen2-VL M-RoPE
    # mixture of experts
    moe: MoEConfig = field(default_factory=MoEConfig)
    # state-space (mamba2 / jamba)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid interleave (jamba: one attention layer per `attn_period`)
    attn_period: int = 0           # 0 -> all-attention model
    attn_offset: int = 0
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500        # whisper: 3000 mel frames / conv stride 2
    # modality frontend stub: None | "audio_frames" | "vision_patches"
    frontend: "str | None" = None
    num_frontend_tokens: int = 0   # vision/audio tokens prepended at prefill
    # norms / activations / misc
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "silu"              # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    max_position: int = 1 << 20
    dtype: str = "bfloat16"
    # bookkeeping
    source: str = ""               # arXiv / model-card citation
    long_context_ok: bool = False  # may run long_500k (sub-quadratic path)
    notes: str = ""

    # -- derived -----------------------------------------------------------

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        return (m.num_experts > 0
                and (i - m.layer_offset) % m.layer_freq == 0
                and i >= m.layer_offset)

    def is_attn_layer(self, i: int) -> bool:
        """hybrid models: which blocks are attention (vs Mamba)."""
        if self.arch_type == "ssm":
            return False
        if self.attn_period <= 0:
            return True
        return i % self.attn_period == self.attn_offset

    def param_count(self) -> float:
        """Approximate N for 6ND-style accounting (embedding included)."""
        d, hd = self.d_model, self.resolved_head_dim()
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            if self.is_attn_layer(i):
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                n += self.num_heads * hd * d
            else:  # mamba block
                di = self.ssm.expand * self.d_model
                n += d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                          + di // self.ssm.head_dim) + di * d
            if self.is_moe_layer(i):
                n += (self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                      + d * self.moe.num_experts)
            elif self.d_ff:
                mult = 3 if self.act == "silu" else 2
                n += mult * d * self.d_ff
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attention
            enc = self.encoder_layers * (4 * d * d + 2 * self.d_ff * d)
            cross = self.num_layers * 4 * d * d
            n += enc + cross
        return float(n)

    def active_param_count(self) -> float:
        """Active params per token (MoE: only routed experts)."""
        if self.moe.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for i in range(self.num_layers)
                         if self.is_moe_layer(i))
        all_exp = moe_layers * self.moe.num_experts * 3 * self.d_model \
            * self.moe.d_ff_expert
        act_exp = moe_layers * self.moe.num_experts_per_tok * 3 \
            * self.d_model * self.moe.d_ff_expert
        return full - all_exp + act_exp

    def structural(self) -> "ModelConfig":
        """Structure-preserving shrink: keeps num_layers / heads / experts
        (the drivers of graph topology, Table 7) while shrinking widths so
        full-depth DAGs build fast and without parameter memory."""
        d = 64
        heads = self.num_heads
        kv = self.num_kv_heads
        moe = self.moe
        if moe.num_experts:
            moe = dataclasses.replace(moe, d_ff_expert=32)
        ssm = self.ssm
        if ssm.d_state:
            ssm = dataclasses.replace(ssm, d_state=8, head_dim=8, chunk=8)
        hd = max(1, d // max(heads, 1)) if heads else 0
        mrope = self.mrope_sections
        if mrope and hd:
            half = hd // 2
            scaled = [max(0, s * half // sum(mrope)) for s in mrope]
            scaled[0] += half - sum(scaled)
            mrope = tuple(scaled)
        return dataclasses.replace(
            self, d_model=d, d_ff=128 if self.d_ff else 0,
            vocab_size=256, head_dim=hd, moe=moe, ssm=ssm,
            mrope_sections=mrope,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else 0,
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            dtype="float32")

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <= 2 layers, d_model <= 512, <= 4 experts."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        layers = min(self.num_layers, 2)
        moe = self.moe
        if moe.num_experts:
            moe = dataclasses.replace(
                moe, num_experts=min(4, moe.num_experts),
                num_experts_per_tok=min(2, moe.num_experts_per_tok),
                d_ff_expert=min(128, moe.d_ff_expert),
                layer_freq=1, layer_offset=0)
        ssm = self.ssm
        if ssm.d_state:
            ssm = dataclasses.replace(ssm, d_state=min(16, ssm.d_state),
                                      head_dim=16, chunk=8)
        new_hd = d // heads if self.num_heads else 0
        mrope = self.mrope_sections
        if mrope and new_hd:
            # rescale M-RoPE sections to the reduced head_dim's rotary half
            half = new_hd // 2
            scaled = [max(1, s * half // sum(mrope)) for s in mrope]
            scaled[0] += half - sum(scaled)
            mrope = tuple(scaled)
        return dataclasses.replace(
            self, num_layers=layers, d_model=d, num_heads=heads,
            num_kv_heads=kv, mrope_sections=mrope,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=d // heads if self.num_heads else 0,
            moe=moe, ssm=ssm,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else 0,
            attn_period=min(self.attn_period, 2) if self.attn_period else 0,
            attn_offset=min(self.attn_offset, 1),
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            dtype="float32")


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def reduced(self) -> "InputShape":
        return InputShape(self.name, min(self.seq_len, 32),
                          min(self.global_batch, 2), self.kind)


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in
                (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
