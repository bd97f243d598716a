"""Roofline for the port on an NVIDIA H100: the three-term model and the
model-FLOP formulas (:mod:`.model`), the ring model of collective bytes
and the counter the collectives record into (:mod:`.comm`), and the
FLOPs and bytes of one step counted as it runs (:mod:`.cost`)."""
