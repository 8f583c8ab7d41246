"""h2o-danube-3-4b — llama+mistral-mix dense decoder with sliding-window
attention [arXiv:2401.16818].

24L, d_model=3840, 32 heads / 8 KV, d_ff=10240, vocab 32000, SWA window
4096 -> native sub-quadratic long_500k path (ring KV cache).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    norm_type="rmsnorm",
    dtype="bfloat16",
    source="arXiv:2401.16818 (H2O-Danube)",
    long_context_ok=True,          # SWA ring cache
)
