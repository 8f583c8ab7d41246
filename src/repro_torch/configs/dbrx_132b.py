"""dbrx-132b — fine-grained MoE decoder [hf:databricks/dbrx-base].

40L, d_model=6144, 48 heads / 8 KV, 16 experts top-4 with d_ff=10752
per expert, vocab 100352.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=0,                        # every block's channel mix is MoE
    vocab_size=100352,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=4,
                  d_ff_expert=10752, layer_freq=1),
    norm_type="rmsnorm",
    dtype="bfloat16",
    source="hf:databricks/dbrx-base",
    long_context_ok=False,
    notes="long_500k skipped: full attention MoE, no SWA variant assigned",
)
