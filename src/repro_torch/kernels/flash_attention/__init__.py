from .flash_attention import (attend_bshd, flash_attention,
                              flash_attention_plain, launches,
                              reset_launches)

__all__ = ["attend_bshd", "flash_attention", "flash_attention_plain",
           "launches", "reset_launches"]
