from .ops import embedding_bag  # noqa: F401
