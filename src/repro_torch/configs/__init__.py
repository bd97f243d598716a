"""Configurations the port supports."""

from .rapidstore import CONFIG, RapidStoreConfig

__all__ = ["CONFIG", "RapidStoreConfig"]
