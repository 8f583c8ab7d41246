"""jamba-v0.1-52b — hybrid Mamba+attention MoE [arXiv:2403.19887].

32 layers, 1 attention layer per 8 (offset 4), MoE every 2nd layer with
16 experts top-2; d_model=4096, 32 heads / 8 KV, d_ff=14336, vocab 65536.
"""

from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attn_period=8,                # 1:7 attention:mamba interleave
    attn_offset=4,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2,
                  d_ff_expert=14336, layer_freq=2, layer_offset=1),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=256,
                  conv_width=4, n_groups=1),
    norm_type="rmsnorm",
    dtype="bfloat16",
    source="arXiv:2403.19887 (Jamba)",
    long_context_ok=True,         # mamba-dominant: decode state is O(1);
                                  # 4 full-attn layers keep seq-sharded KV
    notes="MoE on odd layers (freq 2 offset 1), attention on layers 4,12,20,28",
)
