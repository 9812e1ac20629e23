"""The benchmark's command: one run of one cell.

    python3 zkbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as the last line of standard output and the numbers that
decided ``correct``, each beside its limit, as the last lines of standard
error. Exits with 2, printing no result, without enough CUDA devices, without
the program beside it, or when JAX or the JAX package was loaded.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[0] = str(REPO)  # the repo's root, not this folder: its modules' names are not top-level
    from zkbench import harness

    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"needs {cell.workload['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if not (REPO / "libzkp_tpu_torch" / "__init__.py").exists():
        print(f"the program, libzkp_tpu_torch, is not in {REPO}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
