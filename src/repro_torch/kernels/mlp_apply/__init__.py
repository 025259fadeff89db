from .ops import mlp_apply  # noqa: F401
