"""Optimizers of the port: AdamW (``adamw``), global-norm clipping
(``clip``) and LR schedules (``schedule``), over nested dicts of tensors
(``tree``)."""
