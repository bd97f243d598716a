"""Find a cell's files by name.

``BENCHMARK.json`` lists the cells (``workloads``) as (configuration,
traffic, chips) and the metrics.  A configuration ``c`` is
``rsbench/configs/c.json``, a traffic mix ``t`` is
``rsbench/traffic/t.json``, a per-layer metric ``m`` is the reader
``rsbench/metrics/m.py`` and a query kind ``k`` that a mix names is
either one of the six built into :mod:`rsbench.queries` or the file
``rsbench/kinds/k.py`` (:func:`kind_module`, which says what the file
defines); adding a cell, a mix, a metric or a query kind adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from . import ROOT


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the metrics a --trace 0 run reports
    per_layer: List[dict]  # the metrics a --trace 1 run reports
    root: Path = ROOT  # the checkout whose files it names


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    names = metric.get("workloads")
    return names is None or cell in names


def config_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "rsbench" / "configs" / f"{name}.json"


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "rsbench" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "rsbench" / "metrics" / f"{name}.py"


def kind_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "rsbench" / "kinds" / f"{name}.py"


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    return json.loads(path.read_text())


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    w = found[0]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(config_path(w["config"], root)),
        traffic=load_json(traffic_path(w["traffic"], root)),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=Path(root),
    )


def _load(prefix: str, name: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The module ``rsbench/metrics/<name>.py`` (loaded by path: metric
    names hold dots).  It defines ``UNIT``, ``LAYER``, ``MOVES`` and
    ``read(trace) -> float | None``."""
    path = metric_path(name, root)
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    return _load("rsbench_metric_", name, path)


def kind_module(name: str, root: Path = ROOT):
    """The query kind ``rsbench/kinds/<name>.py``, loaded by path.  It
    imports the program only inside its functions, and defines:

    - ``USES``: ``"coo"`` or ``"tiles"``, what of the view a check
      fingerprints;
    - ``NUMBERS``: ``{number: limit}``, the numbers its checks add to a
      run's result, each summed over the checked answers;
    - optionally ``prepare(ctx)``: once in set-up, what the draws read,
      stored in ``ctx``;
    - ``draw(ctx, arg)``: the query's operands, made from the seed
      (``ctx["seed"]``) and the plan's ``arg``, before the read's clock
      starts: keep it small, as it runs in the window;
    - ``run(view, ctx, ops)``: the calls into the program, returning the
      answer;
    - ``control(view, ctx, ops)``: the plain reference in the program's
      place, in the precision below the configuration's, reading the
      view's COO (``calibrate.py --control``);
    - ``capture(view, answer, ctx, ops) -> dict``: what the judge needs
      of a checked query beyond the fingerprint (``"answer"`` among it);
    - ``hold(check, src, dst, n, ctx) -> dict``: the numbers of one
      checked answer against the reference over the replayed edges;
    - optionally ``bounds(view, ctx, ops) -> {kernel: [seconds]}``: the
      least time of each kernel launch the query made, for a roofline
      share in a traced run.

    ``ctx`` holds the run's seed, ``n``, the configuration, the traffic
    mix, the harness's sorted base edge keys and the device."""
    path = kind_path(name, root)
    if not path.is_file():
        raise FileNotFoundError(f"no query kind file {name!r}: {path}")
    return _load("rsbench_kind_", name, path)


def readers(metrics: List[dict], root: Path = ROOT) -> Dict[str, object]:
    return {m["name"]: metric_reader(m["name"], root) for m in metrics}
