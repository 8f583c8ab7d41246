"""stablelm-3b — dense decoder [hf:stabilityai/stablelm-2-1_6b family].

32L, d_model=2560, 32 heads / 32 KV (MHA), d_ff=6912, vocab 50304.
LayerNorm + partial-rotary family; we keep full rotary for uniformity
(noted deviation).  Smallest full model -> used in CPU-runnable examples.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm_type="layernorm",
    act="silu",
    dtype="bfloat16",
    source="hf:stabilityai/stablelm-2-1_6b (scaled per assignment)",
    long_context_ok=False,
    notes="long_500k runs only as the sliding-window VARIANT (window 4096)",
)
