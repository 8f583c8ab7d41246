"""whisper-tiny — encoder-decoder ASR backbone [arXiv:2212.04356].

4 encoder + 4 decoder layers, d_model=384, 6 heads (MHA: kv=6),
d_ff=1536, vocab 51865.  Conv/mel frontend is a stub: ``input_specs``
supplies frame embeddings (B, S, 384).  Also one of the Parallax paper's
own five evaluation models (Tables 3-7).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,                 # decoder layers
    encoder_layers=4,
    is_encoder_decoder=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,               # MHA
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
    frontend="audio_frames",
    encoder_seq=1500,             # 3000 mel frames / conv stride 2
    dtype="bfloat16",
    source="arXiv:2212.04356 (Whisper); Parallax paper Table 2",
    long_context_ok=False,
    notes="long_500k skipped: decoder context 448, encoder 1500 frames",
)
