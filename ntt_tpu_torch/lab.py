"""The kernel lab: transform candidates and cost probes, each checked bit
for bit and timed on the card.

    python -m ntt_tpu_torch.lab [--cases u32|u64|both] [--batch 512] [--m 14]
                                [--reps 3] [--only NAMES] [--no-time]
                                [--device cuda|cpu]

The counterpart of ``tools/pallas_lab.py``.  At N = 2^m, a word-32 q
(``NttParams.generate(27, m)``) and a word-64 q (``bench_params(m, 62)``),
it runs on one batch of random polynomials below q:

  * ``v1``: K1 (``kernels.fused.fwd_fused``);
  * ``v2-r2`` / ``v2-r4``: L1 in rounds of one / two stages
    (``kernels.fused_lab.fwd_fused_v2``); v2-r2 is K1's first design, one
    radix-2 stage a pass over shared memory;
  * ``v3``: L2, the Stockham flow (``fused_lab.fwd_fused_v3``);
  * ``i1``: K2 (``kernels.fused.inv_fused``);
  * ``diag-copy``, ``diag-math`` (m rounds), ``diag-moves``, ``diag-mul``
    (42 multiplies): the L3 probes (``kernels.probes``), which split the
    first K1 design's time into memory, arithmetic, movement and
    multiplies.

L1 and L2 run at the split N2 = 128 (``n1_log = m - 7``), as the Pallas lab.
Every forward candidate must equal the plain six-step at that split
(``kernels.fused_lab.plain``) and v1's output, i1 the plain inverse six-step
(``fused_lab.plain_inv``); every probe must equal its plain version on the
same tensor.  A mismatch raises.  Times are device
times (``cuda_us``: a CUDA graph of ``INNER`` calls between two CUDA
events, after two warm-up calls, the minimum over ``--reps``), printed per
transform beside the card's name and power limit.
With ``--device cpu`` every candidate is its plain version and nothing is
timed.  Under the NTT_MULMOD=solinas switch (``modmath.USE_SOLINAS``) a
case whose q takes the Solinas product (``modmath.solinas_args``: the
word-64 q at m14, 2^62 - 2^16 + 1, and the word-32 q at m10,
2^27 - 2^11 + 1) runs every candidate with it, K1 / K2 and L1-L3 in their
Solinas instantiations, as the JAX lab does under the same switch; each
case prints the product its butterflies took, and each time says it again.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, NamedTuple

import numpy as np
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import fused, fused_lab, probes
from ntt_tpu_torch.params import NttParams, bench_params
from ntt_tpu_torch.plan import NttPlan, get_plan

CANDIDATES = ("v1", "v2-r2", "v2-r4", "v3", "i1",
              "diag-copy", "diag-math", "diag-moves", "diag-mul")
CASES = {"u32": ("u32",), "u64": ("u64",), "both": ("u32", "u64")}
INNER = 20  # launches a timed CUDA graph holds


def case_params(case: str, m: int) -> NttParams:
    """The lab's q at each width: a 27-bit prime or the 62-bit bench q."""
    return NttParams.generate(27, m) if case == "u32" else bench_params(m, 62)


def lab_split(m: int) -> int:
    """log2 N1 of L1 / L2 in the lab: N2 = 128 lanes, as the Pallas lab."""
    return max(1, m - 7)


class Candidate(NamedTuple):
    """One lab candidate: the call under test, its plain version on the same
    input (named by ``plain_label``), the kernel it launches (its LAUNCHES
    key less the width), and whether its output must also equal v1's."""

    fn: Callable
    plain: Callable
    kernel: str
    like_v1: bool = False
    plain_label: str = "the plain six-step"


def candidates(plan: NttPlan, n1_log: int) -> dict[str, Candidate]:
    """name -> Candidate.  The forward transforms' plain version is the
    plain six-step and their output v1's; K2's the plain inverse six-step; a
    probe's is its own."""
    m = plan.m
    six = lambda x: fused_lab.plain(x, plan, n1_log)  # noqa: E731
    return {
        "v1": Candidate(lambda x: fused.fwd_fused(x, plan), six, "fwd_fused"),
        "v2-r2": Candidate(lambda x: fused_lab.fwd_fused_v2(x, plan, n1_log, group=1), six,
                           "fwd_fused_v2_r2", True),
        "v2-r4": Candidate(lambda x: fused_lab.fwd_fused_v2(x, plan, n1_log, group=2), six,
                           "fwd_fused_v2_r4", True),
        "v3": Candidate(lambda x: fused_lab.fwd_fused_v3(x, plan, n1_log), six,
                        "fwd_fused_v3", True),
        "i1": Candidate(lambda x: fused.inv_fused(x, plan),
                        lambda x: fused_lab.plain_inv(x, plan), "inv_fused", False,
                        "the plain inverse six-step"),
        "diag-copy": Candidate(probes.diag_copy, lambda x: x.clone(), "diag_copy", False,
                               "its plain version"),
        "diag-math": Candidate(lambda x: probes.diag_math(x, plan, m),
                               lambda x: probes.plain_math(x, plan, m), "diag_math", False,
                               "its plain version"),
        "diag-moves": Candidate(probes.diag_moves, lambda x: x.flip(-1), "diag_moves", False,
                                "its plain version"),
        "diag-mul": Candidate(probes.diag_mul, probes.plain_mul, "diag_mul", False,
                              "its plain version"),
    }


def card(device: torch.device) -> str:
    """'name, power limit' as nvidia-smi gives them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_us(fn, x, reps: int, inner: int) -> float:
    """Device time of one call in us: `inner` calls captured in a CUDA
    graph after two warm-up calls, the replay timed between two CUDA
    events, the minimum over reps.  The graph takes the host's launch
    overhead (tens of us a call) out of the time of a short kernel."""
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn(x)
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / inner)
    del graph
    return best


def run_case(case: str, args, device: torch.device, where: str) -> list[dict]:
    p = case_params(case, args.m)
    plan = get_plan(p)
    sol = mm.solinas_args(plan.q, plan.word)  # the switch, read for this case
    product = f"Solinas (e={sol[0]}, k={sol[1]})" if sol else "Shoup"
    n1_log = lab_split(p.m)
    rng = np.random.default_rng(0)
    x = mm.from_host(rng.integers(0, p.q, size=(args.batch, p.n), dtype=np.uint64), p.q,
                     device)
    print(f"[{case}] q={p.q:#x} N=2^{p.m} batch={args.batch} n1_log={n1_log}, single "
          f"product {product}, on {where}", flush=True)
    cands = candidates(plan, n1_log)
    names = [n for n in CANDIDATES if not args.only or n in args.only]
    records, v1 = [], None
    for name in names:
        cand = cands[name]
        got = cand.fn(x)
        refs = {cand.plain_label: cand.plain(x)}
        if cand.like_v1 and v1 is not None:
            refs["v1 (K1)"] = v1
        if name == "v1":
            v1 = got
        for label, ref in refs.items():
            if not torch.equal(got, ref):
                raise AssertionError(f"[{case}] {name}: differs from {label}")
        what = " and ".join(refs)
        rec = {"case": case, "name": name, "m": p.m, "batch": args.batch, "exact": True,
               "product": product, "us_per_transform": None}
        line = f"  {name}: bit-exact against {what}"
        if not args.no_time and device.type == "cuda":
            us = cuda_us(cand.fn, x, args.reps, INNER) / args.batch
            rec["us_per_transform"] = us
            line += (f"; {us:.4f} us/transform ({1e6 / us:,.0f} transforms/s, {product} "
                     f"product) on {where}")
        print(line, flush=True)
        records.append(rec)
    return records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="u32", choices=sorted(CASES))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--m", type=int, default=14)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", type=lambda s: s.split(","), default=None,
                    help="comma list of candidate names")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    unknown = sorted(set(args.only or ()) - set(CANDIDATES))
    if unknown:
        ap.error(f"unknown candidates {unknown}; choose from {', '.join(CANDIDATES)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to run the plain versions")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        where = card(device)
    else:
        where = "the CPU (plain versions, not timed)"
    return [rec for case in CASES[args.cases] for rec in run_case(case, args, device, where)]


if __name__ == "__main__":
    main()
