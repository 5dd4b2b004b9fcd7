"""CLI: the reference's correctness sweep over the port's variants, and the bench.

    python -m ntt_tpu_torch list                   # variant registry + capabilities
    python -m ntt_tpu_torch correctness            # oracle sweep (fast fixtures)
    python -m ntt_tpu_torch correctness --full     # all 19 reference fixtures
    python -m ntt_tpu_torch correctness --device cpu   # the plain PyTorch path
    python -m ntt_tpu_torch bench [--] [ARGS]      # ntt_tpu_torch.bench: one JSON line

The counterpart of ``ntt_tpu/__main__.py``.  ``bench`` hands its
arguments (a leading ``--`` dropped) to ``ntt_tpu_torch.bench.main``;
see that module for the JSON line.  In ``correctness``, per fixture, every
variant capable at its q runs the strict forward, which after
``output_layout(...).fix`` must equal the oracle, and the inverse round
trip; one ``OK`` / ``FWD-MISMATCH`` / ``ROUNDTRIP-FAIL`` line each, then
``FAILURES: n``, exit 1 on any failure.  The oracle is the plain
``radix2`` forward on the CPU, which the CPU tests hold bit-exact against
the reference model.  A variant the port refuses by design at a fixture
(``pallas-fused`` beyond one block) prints ``SKIP`` with the reason and
is no failure.  ``--device`` defaults to ``cuda``; without a card that
raises.
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_list(_args) -> int:
    from ntt_tpu_torch import api

    print(f"{'variant':18s} {'fwd':3s} {'inv':3s} {'max q':6s} description")
    for name, v in sorted(api.variants().items()):
        print(
            f"{name:18s} {'yes':3s} {'yes' if v.inv else '-':3s} "
            f"2^{v.max_q_bits:<4d} {v.description}"
        )
    return 0


def cmd_correctness(args) -> int:
    """Oracle sweep: every capable variant's strict forward against the
    plain radix-2 oracle (after the layout's fix) and its inverse round
    trip, per fixture -- the reference's test_correctness pattern."""
    import numpy as np

    from ntt_tpu_torch import api
    from ntt_tpu_torch.params import FIXTURES
    from ntt_tpu_torch.plan import get_plan

    if args.fixtures:
        fixtures = [FIXTURES[int(i)] for i in args.fixtures.split(",")]
    else:
        fixtures = FIXTURES if args.full else [FIXTURES[i] for i in (0, 1, 2, 3, 9, 13)]
    skip = set(args.skip.split(",")) if args.skip else set()
    rng = np.random.default_rng(args.seed)
    failures = 0
    for p in fixtures:
        plan = get_plan(p)
        a = rng.integers(0, p.q, size=(p.n,), dtype=np.uint64)
        want = api.fwd_ntt(a, plan, "radix2", device="cpu")
        for name, v in sorted(api.variants().items()):
            if name in skip or p.q.bit_length() > v.max_q_bits:
                continue
            try:
                api._pick(plan, name, inverse=True, rows=1)
            except ValueError as refused:  # by design: the variant does not serve this (q, m)
                print(f"q={p.q:#018x} m={p.m:2d} {name:18s} SKIP ({refused})", flush=True)
                continue
            t0 = time.perf_counter()
            raw = api.fwd_ntt(a, plan, variant=name, device=args.device)
            ok = bool((api.output_layout(name, plan).fix(raw) == want).all())
            rt = True
            if ok and v.inv is not None:
                # inverses consume the variant's NATIVE output layout
                rt = bool((api.inv_ntt(raw, plan, variant=name, device=args.device) == a).all())
            status = "OK" if (ok and rt) else ("FWD-MISMATCH" if not ok else "ROUNDTRIP-FAIL")
            failures += status != "OK"
            print(
                f"q={p.q:#018x} m={p.m:2d} {name:18s} {status}"
                f"  ({time.perf_counter() - t0:.1f}s)",
                flush=True,
            )
    print("FAILURES:", failures)
    return 1 if failures else 0


def cmd_bench(rest: list[str]) -> int:
    from ntt_tpu_torch import bench

    return bench.main(rest[1:] if rest[:1] == ["--"] else rest)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        # every argument after it is the bench's; argparse's REMAINDER would
        # refuse one that starts with '-'
        return cmd_bench(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m ntt_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    c = sub.add_parser("correctness")
    c.add_argument("--full", action="store_true", help="all 19 reference fixtures")
    c.add_argument("--fixtures", default=None,
                   help="comma list of fixture indices (0..18) to sweep")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--skip", default="", help="comma-separated variants to skip")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the variants run (cpu: their plain PyTorch versions)")
    sub.add_parser("bench", help="time the API: python -m ntt_tpu_torch bench --help")
    args = ap.parse_args(argv)
    return {"list": cmd_list, "correctness": cmd_correctness}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
