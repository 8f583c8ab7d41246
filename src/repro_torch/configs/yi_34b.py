"""yi-34b — llama-architecture dense GQA decoder [arXiv:2403.04652].

60L, d_model=7168, 56 heads / 8 KV, d_ff=20480, vocab 64000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    norm_type="rmsnorm",
    dtype="bfloat16",
    source="arXiv:2403.04652 (Yi)",
    long_context_ok=False,
    notes="long_500k runs only as the sliding-window VARIANT (window 4096)",
)
