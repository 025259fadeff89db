"""Dense-GQA transformer LM: config, forward, KV-cache decode, serving
steps.  Prefill attention runs through the hand-written ``flash_attention``
kernel."""
from .config import LMConfig, MLAConfig, MoEConfig  # noqa: F401
