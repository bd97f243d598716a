"""repro_torch: RapidStore's snapshot read path, LM decode serving and BST
recsys serving on PyTorch and CUDA.

The port of :mod:`repro` (JAX on a TPU) to an NVIDIA H100.  It imports
``torch`` and numpy, never ``jax`` or anything of ``repro``.

Layers
------
- ``repro_torch.core``    — the MVCC store (host engine, copied from the
  reference), the device tile cache and view assembler, and the analytics.
- ``repro_torch.kernels`` — hand-written CUDA kernels (``csrc/*.cu``) for
  leaf search, scan-reduce, SpMM, intersect, embedding_bag and
  flash_decode, each beside its plain PyTorch version;
  ``kernels.runtime`` builds them with ``nvcc``.
- ``repro_torch.models``  — the LM decode half (``transformer``), BST
  (``bst``), shared blocks and the bridge from the reference's parameters.
- ``repro_torch.serve`` / ``repro_torch.launch`` — the greedy decode step
  and ``python -m repro_torch.launch.serve``.
- ``repro_torch.configs`` — the store's and the model families' configs.
- ``repro_torch.graph``   — R-MAT / uniform edge generators.
- ``repro_torch.obs``     — metrics, span tracing and exporters.
"""

__version__ = "0.1.0"
