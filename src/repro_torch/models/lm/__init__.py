"""Transformer LMs (dense GQA, MoE, MLA + multi-token prediction):
config, forward, KV-cache decode, serving steps.  A GQA prefill's
attention runs through the hand-written ``flash_attention`` kernel."""
from .config import LMConfig, MLAConfig, MoEConfig  # noqa: F401
