"""Hand-written CUDA kernels for RapidStore's hot spots on Hopper.

Each kernel package ships two modules:

- ``ops.py`` — the public wrapper: a CPU tensor takes the plain version, a
  CUDA tensor launches the kernel built from ``csrc/<name>.cu`` (anything
  else raises); each wrapper counts its launches in ``.launches``,
- ``ref.py`` — the plain PyTorch version.

Inventory (paper hot spot -> kernel):

- Search(u, v) probes           -> ``leaf_search``
- Scan-heavy analytics (PR/GNN) -> ``spmm`` (``leaf_scan_reduce``, ``leaf_spmm``)
- set intersection / TC (§6.2)  -> ``intersect`` (``intersect_count``)
"""
