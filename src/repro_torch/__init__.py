"""repro_torch: RapidStore's snapshot read path on PyTorch and CUDA.

The port of :mod:`repro` (JAX on a TPU) to an NVIDIA H100.  It imports
``torch`` and numpy, never ``jax`` or anything of ``repro``.

Layers
------
- ``repro_torch.core``    — the MVCC store (host engine, copied from the
  reference), the device tile cache and view assembler, and the analytics.
- ``repro_torch.kernels`` — hand-written CUDA kernels (``csrc/*.cu``) for
  leaf search, scan-reduce, SpMM and intersect, each beside its plain
  PyTorch version; ``kernels.runtime`` builds them with ``nvcc``.
- ``repro_torch.graph``   — R-MAT / uniform edge generators.
- ``repro_torch.obs``     — metrics, span tracing and exporters.
"""

__version__ = "0.1.0"
