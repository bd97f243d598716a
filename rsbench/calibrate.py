"""Readings for the limits of ``correct``: the program's numbers on many
seeds, and the control's (the plain reference in bfloat16 in the
program's place) on the same set-ups.

    python3 rsbench/calibrate.py --workload <name> --seeds 11,12,13 --seconds 10 [--control]

Each seed builds its cell at full size, runs a short window of the
program and judges it, then (with ``--control``) a window of the same
length with the control on the same store, judged the same way.  One JSON
line per window; the benchmark's own runs never run this.
"""

import os
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(os.path.dirname(here), "src"), os.path.dirname(here)]
    import argparse
    import json
    import time

    import torch

    from rsbench import harness, spec
    from rsbench.reference import judge

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        state = harness.setup(cell, seed, device, False, n_windows=2, seconds=args.seconds)
        roles = ("program", "control") if args.control else ("program",)
        for role in roles:
            w = harness.window(state, args.seconds, False, control=role == "control")
            numbers = harness.check(state, w, harness.final_view(state))
            limits = judge.limits(harness.file_kinds(cell))
            print(json.dumps({"workload": cell.name, "seed": seed, "role": role,
                              "correct": judge.verdict(numbers, limits), "numbers": numbers,
                              "checks": len(w.checks),
                              "reads": harness.read_line(w)["completed_in_window"],
                              "seconds_so_far": time.perf_counter() - t0}), flush=True)
        harness.free_program(state)
        del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
