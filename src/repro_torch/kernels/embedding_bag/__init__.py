from .ops import embedding_bag

__all__ = ["embedding_bag"]
