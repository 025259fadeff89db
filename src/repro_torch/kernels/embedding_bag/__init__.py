from .ops import EmbeddingBagFn, embedding_bag  # noqa: F401
