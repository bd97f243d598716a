"""The paper system's own hyperparameters (§6.5): |P|=64, B=512."""

from dataclasses import dataclass


@dataclass(frozen=True)
class RapidStoreConfig:
    partition_size: int = 64  # |P|
    leaf_width: int = 512  # B
    high_degree_threshold: int = 256
    tracer_k: int = 32  # reader tracer slots (defaults to core count)


CONFIG = RapidStoreConfig()
