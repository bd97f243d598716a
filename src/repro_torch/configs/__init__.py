"""Configurations the port supports: the store's own (``rapidstore``) and
the model families' (``base``, ``registry`` and one module per
architecture, copied from the reference)."""

from .rapidstore import CONFIG, RapidStoreConfig

__all__ = ["CONFIG", "RapidStoreConfig"]
