"""python3 -m nttbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json`` on the cards it asks for
(``cuda:0`` ... ``cuda:<chips-1>``, one process): its one-line JSON
result as the last line of stdout, each compared number beside its
limit as the last lines of stderr.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits 2 and prints no result; if JAX or
the JAX package was loaded by the time the window closed, it exits 3 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from nttbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m nttbench", description=__doc__.split("\n\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the CUDA driver's kernel cache, at a fixed path in the checkout (read
    # when the driver starts, in torch.cuda.is_available below)
    os.environ.setdefault("CUDA_CACHE_PATH", str(harness.ROOT / ".nttbench_cache" / "cuda"))
    cell = harness.Cell.load(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nttbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    found = harness.foreign_modules()
    if found:
        print(f"nttbench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
