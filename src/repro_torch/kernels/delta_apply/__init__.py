from .ops import delta_apply  # noqa: F401
