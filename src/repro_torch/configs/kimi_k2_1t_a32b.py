"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table scale)
[arXiv:2501.kimi2 / hf:moonshotai/Kimi-K2].

61L, d_model=7168, 64 heads / 8 KV, 384 experts top-8 with per-expert
d_ff=2048, 1 shared expert, first layer dense, vocab 163840.
Fitting on 512 chips requires full FSDP + bf16 optimizer moments
(DESIGN.md §5).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                    # dense first layer / shared-path width
    vocab_size=163840,
    rope_theta=5e7,
    moe=MoEConfig(num_experts=384, num_experts_per_tok=8,
                  d_ff_expert=2048, layer_freq=1, layer_offset=1,
                  num_shared_experts=1),
    norm_type="rmsnorm",
    dtype="bfloat16",
    source="arXiv:2501.kimi2 (Kimi K2, trillion-param MoE)",
    long_context_ok=False,
    notes="first layer dense (layer_offset=1); long_500k skipped: full attention",
)
