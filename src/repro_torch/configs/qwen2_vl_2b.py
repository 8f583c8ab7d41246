"""qwen2-vl-2b — vision-language decoder backbone [arXiv:2409.12191].

28L, d_model=1536, 12 heads / 2 KV (GQA), d_ff=8960, vocab 151936.
M-RoPE with sections (16, 24, 24) over the rotary half of head_dim=128.
The ViT/dynamic-resolution vision encoder is a stub: ``input_specs``
supplies patch embeddings + 3-stream position ids.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    frontend="vision_patches",
    num_frontend_tokens=1024,     # dynamic-resolution grid (stubbed fixed)
    tie_embeddings=True,          # 2B variant ties embeddings
    dtype="bfloat16",
    source="arXiv:2409.12191 (Qwen2-VL)",
    long_context_ok=False,
    notes="long_500k skipped: full attention, no SWA variant assigned",
)
