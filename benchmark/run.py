#!/usr/bin/env python3
"""Run one cell of the benchmark of ``shadowing_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It makes the cell's dataset and traffic from ``--seed``, builds the
port's engine and warms every shape the traffic uses (the set-up), runs a
closed loop for ``--seconds`` (the window), with ``--trace 1`` profiles a
few more calls, then frees the program's state and checks a sample of the
window's answers against the plain float64 reference.

Earlier lines of standard output carry the evidence (route, launches per
kernel, redone contexts, peak memory, the card's clocks and power); the
last is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit, which are also the last
lines of standard error. Without a CUDA card, or with JAX or the JAX
package loaded, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    found = harness.forbidden(list(sys.modules))
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
