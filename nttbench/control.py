"""The control of the check: the plain reference put in the program's
place, its modular products in float64 (``reference.mulmod_f64``), run
through the rest of a cell's run at the cell's own size.

    python3 -m nttbench.control --workload <name> --seeds 1,2,3 [--seconds 1]

One JSON line a seed on stdout: ``correct`` and the compared numbers.
The check must read it as not correct; the benchmark's own runs never run
this.  Needs a CUDA card, as the cells do.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from nttbench import harness


def control_system(config: dict, devices: list[torch.device]):
    """``build``'s signature: the reference tower in float64 products, on
    the device of its inputs."""
    ref = harness.load_module(harness.ROOT, "reference", config["reference"])
    return ref.Tower([int(q, 16) for q in config["moduli"]], mul=ref.mulmod_f64), \
        {"library_s": 0.0, "tables_s": 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m nttbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nttbench.control needs a CUDA card", file=sys.stderr)
        return 2
    for seed in map(int, args.seeds.split(",")):
        res = harness.run(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                          system=control_system)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "float64",
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
