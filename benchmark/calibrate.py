#!/usr/bin/env python3
"""Readings that the check's limits are set from; never run by a benchmark
run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2]

In one process, for each seed: one run of the cell with a short window
(at least as many calls as a run compares) and the check's numbers; then
the same with the control, the plain reference computed in TF32 in the
program's place. One JSON line per run on standard output. The limit of
each number lies between the port's largest reading and the control's
smallest (``limits/<cell>.json`` records both).
"""
import time

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    n_check = int(cell.traffic.get("check_queries", 1))
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, "cuda", t,
                          control=control, min_calls=n_check)
        torch.cuda.empty_cache()
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "system": "control (reference in TF32)" if control else "program",
            "readings": {k: v["value"] for k, v in res["checks"].items()},
            "correct": res["correct"], "attempted": res["attempted"],
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
