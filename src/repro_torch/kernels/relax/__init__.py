from .ops import edge_relax

__all__ = ["edge_relax"]
