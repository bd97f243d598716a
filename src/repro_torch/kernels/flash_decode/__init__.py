from .ops import flash_decode, flash_decode_partial, merge_partials, route

__all__ = ["flash_decode", "flash_decode_partial", "merge_partials", "route"]
