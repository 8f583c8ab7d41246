"""mamba2-370m — attention-free SSD state-space model [arXiv:2405.21060].

48L, d_model=1024, ssm_state=128, attention-free (num_heads=0), no MLP
(d_ff=0; each block is a Mamba2 mixer), vocab 50280.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,                   # attention-free
    num_kv_heads=0,
    d_ff=0,                        # mixer-only blocks (Mamba2)
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256,
                  conv_width=4, n_groups=1),
    norm_type="rmsnorm",
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2405.21060 (Mamba2 / SSD)",
    long_context_ok=True,          # O(1) decode state
    notes="Parallax delegate model treats the scan as fallback-like (DESIGN §4)",
)
