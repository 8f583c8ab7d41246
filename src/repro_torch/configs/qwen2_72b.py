"""qwen2-72b — dense GQA decoder with QKV bias [arXiv:2407.10671].

80L, d_model=8192, 64 heads / 8 KV, d_ff=29568, vocab 152064.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
    dtype="bfloat16",
    source="arXiv:2407.10671 (Qwen2)",
    long_context_ok=False,
    notes="long_500k runs only as the sliding-window VARIANT (window 4096)",
)
