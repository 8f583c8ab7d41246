from .paged_attention import (launches, paged_append, paged_append_plain,
                              paged_decode_attention,
                              paged_decode_attention_plain, reset_launches)

__all__ = ["launches", "paged_append", "paged_append_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "reset_launches"]
