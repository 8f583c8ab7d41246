from .decode_attention import (decode_attention, decode_attention_plain,
                               launches, reset_launches)

__all__ = ["decode_attention", "decode_attention_plain", "launches",
           "reset_launches"]
