"""Readings of the comparison that decides ``correct``, under the control or
a planted fault (``faults.py``), at a cell's own size, on several seeds in
one process: one JSON line a seed with each compared number.

    python3 zkbench/control.py --workload range64.b1024 --hook narrow \\
        --seeds 11,12,13 --seconds 10

``--hook none`` reads the program as it is. The benchmark's runs never run
this.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--hook", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(REPO)
    from zkbench import faults, harness

    cell = harness.Cell(args.workload)
    hook = None if args.hook == "none" else faults.HOOKS[args.hook]
    for seed in [int(s) for s in args.seeds.split(",")]:
        try:
            r = harness.run(cell, seed, args.seconds, False, hook=hook)
            line = {"seed": seed, "correct": r["correct"], "compared": r["compared"],
                    "attempted": r["attempted"], "metrics": r["metrics"]}
        except Exception as e:  # a control that crashes has failed, and gives no number
            line = {"seed": seed, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps({"workload": args.workload, "hook": args.hook, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
