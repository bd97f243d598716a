"""rsbench: the benchmark of the PyTorch and CUDA port of RapidStore.

One command runs one cell (a configuration under a traffic mix) once::

    python3 rsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  ``BENCHMARK.json`` at the checkout's root
names the cells and metrics; each configuration is
``rsbench/configs/<name>.json``, each traffic mix
``rsbench/traffic/<name>.json``, each per-layer metric a reader
``rsbench/metrics/<name>.py`` and each query kind beyond the six built
into :mod:`rsbench.queries` a file ``rsbench/kinds/<name>.py``, all found
by name (:mod:`rsbench.spec`).

What measures is frozen here and imports nothing of the program: the
R-MAT generator, the SSSP weights and the edge fingerprints
(:mod:`rsbench.gen`), the H100 peaks and the kernels' byte counts
(:mod:`rsbench.yardstick`), and the plain reference that decides
``correct`` (:mod:`rsbench.reference`).  The system under test is
``repro_torch`` alone; nothing here imports JAX or the JAX package.
"""

from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent  # the checkout: BENCHMARK.json and src/ live here
