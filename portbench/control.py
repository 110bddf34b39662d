"""Readings for a cell's limit: the program and its control over many seeds.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 3 [--variant <control>]

Runs the cell once per seed in one process, each with a short window at the
cell's own size and load, and prints one JSON line per seed: the seed,
``correct`` and every number the check compared. Without ``--variant`` the
program runs as the configuration states it (the lower reading); with
``--variant <control>`` at the keywords of that entry of the
configuration's ``controls``, a step down in precision that would tempt a
later change (the upper reading). The benchmark's own runs never run this.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variant", default=None, help="a name in the configuration's controls")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.variant is not None and args.variant not in cell.config["controls"]:
        print(f"portbench.control: no control {args.variant!r}; {sorted(cell.config['controls'])}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda"), variant=args.variant)
        print(json.dumps({"workload": cell.name, "variant": args.variant or "program", "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "compared": r["compared"], "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
