"""Recommendation models: DLRM-RM2, its sum-mode bags through the
``embedding_bag`` kernel."""
from .dlrm import dlrm_forward, init_dlrm  # noqa: F401
