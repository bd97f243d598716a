from .ops import edge_search_view, leaf_search

__all__ = ["edge_search_view", "leaf_search"]
