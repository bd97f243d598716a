"""Run one cell of the benchmark once and print its result.

    python3 rsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``rsbench/``
and the program under ``src/repro_torch``.  With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy time and the breakdown.  The last line of
standard output is the result; the lines before it describe the run (set-up
parts, the readers' latencies, the writer's lateness).  The numbers that
decide ``correct`` are the last lines of standard error and the result's
last key.  Without a CUDA card, or with fewer than the cell asks for, it
exits with 2 and prints no result; if JAX or the JAX package is loaded
once the window has closed, with 3.
"""

import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the moment this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - min(max(0.0, age), 60.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def _environment(trace: bool) -> None:
    """Caches inside the checkout at fixed paths; no inherited setting of
    the program's (``REPRO_*``) changes what runs; a traced run keeps
    every span of its window."""
    for key in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[key]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    if trace:
        os.environ["REPRO_TELEMETRY_RING"] = str(1 << 21)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    args = _parse(argv)
    _environment(bool(args.trace))
    import json

    import torch

    from rsbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rsbench: the cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    readers = spec.readers(cell.per_layer) if args.trace else {}
    if args.trace:
        from repro_torch.obs import trace as obs_trace

        obs_trace.enable()

    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)

    found = forbidden_modules()
    if found:
        print(f"rsbench: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3

    w = res["window"]
    print(json.dumps({"line": "setup", **res["setup"]}))
    print(json.dumps(harness.read_line(w)))
    if w.writes:
        print(json.dumps(harness.write_line(w)))
    metrics = {}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": res["peak"]}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        tr = res["trace"]
        for m in cell.per_layer:
            value = readers[m["name"]].read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out.update(metrics=metrics, device=device_info, breakdown=w.breakdown)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name in units:
            value = res["e2e"][name]
            metrics[name] = {"value": value if value != float("inf") else 1e300,
                             "unit": units[name]}
        out.update(metrics=metrics, device=device_info)
    checks = {k: {"value": v, "limit": res["limits"][k]} for k, v in res["numbers"].items()}
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
