from .ops import shrink_pull  # noqa: F401
