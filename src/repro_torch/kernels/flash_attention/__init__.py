from .ops import FlashAttentionFn, flash_attention  # noqa: F401
