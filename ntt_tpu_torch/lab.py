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
    (``kernels.fused_lab.fwd_fused_v2``): K1's in-place rounds, one
    exchange through shared memory a round, stopping at the N1 | N2
    boundary;
  * ``v3``: L2, the Stockham flow (``fused_lab.fwd_fused_v3``) in rounds
    of up to four stages that read the same positions every round;
  * ``i1``: K2 (``kernels.fused.inv_fused``);
  * ``diag-copy``, ``diag-math`` (m rounds), ``diag-moves``, ``diag-mul``
    (42 multiplies): the L3 probes (``kernels.probes``).  All four run
    K1's design point, and three of them split K1's time (``k1_split``):
    its memory path (``diag-copy``), what its butterflies add
    (``diag-math`` - ``diag-copy``: K1's m rounds of N/2 butterflies on
    K1's memory path), its exchanges and barriers (``diag-moves`` -
    ``diag-copy``), and what its twiddle loads and the rest add (K1 -
    ``diag-moves`` - (``diag-math`` - ``diag-copy``)); ``diag-mul`` prices
    the 32-bit multiplies the bounds divide by.

K1, L1 and L2 run at one design point (K1's: 16 words a thread, at most
512 threads, the padded exchange buffer), so their times differ by their
algorithms alone; K1 (3 exchanges at m14), L1 in rounds of two (7) and
of one stage (13) give the price of one exchange.  L1 and L2 run at the
split N2 = 128 (``n1_log = m - 7``), as the Pallas lab.
Every forward candidate must equal the plain six-step at that split
(``kernels.fused_lab.plain``) and v1's output, i1 the plain inverse six-step
(``fused_lab.plain_inv``); every probe must equal its plain version on the
same tensor.  A mismatch raises.  Times are device
times (``cuda_us``: a CUDA graph of ``INNER`` calls between two CUDA
events, after two warm-up calls, the minimum over ``--reps``), printed per
transform beside the card's name and power limit.  Where K1 and the three
probes are timed, each case ends with K1's split beside ``Tensor.clone()``
and ``Tensor.flip(-1)`` on the same input (the one PyTorch call that
computes each probe's function) and each one's bound, the bytes it must
move over the H100's 3.35 TB/s.  With ``--device cpu`` every candidate is
its plain version and nothing is timed, the split included.  Under the
NTT_MULMOD=solinas switch (``modmath.USE_SOLINAS``) a case whose q takes the Solinas product (``modmath.solinas_args``: the
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
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


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


def k1_split(k1: float, copy: float, moves: float, math: float) -> dict[str, float]:
    """K1's time split by the three probes on its design point, all four
    timed at the same shape: its memory path (diag_copy), what its
    butterflies add (diag_math - diag_copy), its exchanges and barriers
    (diag_moves - diag_copy), and what its twiddle loads and the rest add
    (K1 - diag_moves - (diag_math - diag_copy)).  Each part is what K1 pays
    beyond the parts before it; warps overlap one part with another, so a
    part is no time of its own and can come out negative."""
    return {"memory path": copy, "butterflies": math - copy,
            "exchanges and barriers": moves - copy,
            "twiddle loads and the rest": k1 - moves - (math - copy)}


def marginal_rates(plan: NttPlan, x: torch.Tensor, reps: int = 3) -> dict[str, float]:
    """What one more step of the two arithmetic probes costs on the card, on
    x (a batch of N = 2^m): diag_mul at N_MULTS and 4 N_MULTS steps and
    diag_math at m and 2m rounds, each timed as the lab times (``cuda_us``,
    us a call).  The differences leave out the memory path both probes
    share with diag_copy, so they give the 32-bit multiplies a second of
    diag_mul's step loop (``mul_per_s``) and the butterflies a second of
    diag_math's round loop (``bfly_per_s``)."""
    m, n, batch = plan.m, x.shape[-1], x.numel() // x.shape[-1]
    k = probes.N_MULTS
    us = {"mul": [cuda_us(lambda v, s=s: probes.diag_mul(v, s), x, reps, INNER)
                  for s in (k, 4 * k)],
          "math": [cuda_us(lambda v, r=r: probes.diag_math(v, plan, r), x, reps, INNER)
                   for r in (m, 2 * m)]}
    halves = n * batch * plan.word // 32
    return {"mul_us": us["mul"], "math_us": us["math"],
            "mul_per_s": 3 * k * halves / ((us["mul"][1] - us["mul"][0]) * 1e-6),
            "bfly_per_s": m * n // 2 * batch / ((us["math"][1] - us["math"][0]) * 1e-6)}


def bytes_bound_us(word: int, m: int, batch: int, tw_words: int = 0) -> float:
    """The least time in us one transform's bytes take at the memory rate:
    each word read and written once, and tw_words words a twiddle entry of
    the forward's N-entry table (2 with Shoup constants, 1 under the
    Solinas product, 0 for the probes), read once a call of batch."""
    words = 2 * (1 << m) + tw_words * (1 << m) / batch
    return words * word / 8 / HBM_BYTES_PER_S * 1e6


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
    us = {r["name"]: r["us_per_transform"] for r in records}
    if all(us.get(k) is not None for k in ("v1", "diag-copy", "diag-moves", "diag-math")):
        split = k1_split(us["v1"], us["diag-copy"], us["diag-moves"], us["diag-math"])
        lib = {k: cuda_us(f, x, args.reps, INNER) / args.batch
               for k, f in (("clone()", lambda v: v.clone()), ("flip(-1)", lambda v: v.flip(-1)))}
        data = bytes_bound_us(plan.word, p.m, args.batch)
        print(f"  K1's split, us/transform: K1 {us['v1']:.4f} (bound "
              f"{bytes_bound_us(plan.word, p.m, args.batch, 1 if sol else 2):.4f}) = "
              + " + ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; diag-copy against clone() {lib['clone()']:.4f}, diag-moves "
              f"{us['diag-moves']:.4f} against flip(-1) {lib['flip(-1)']:.4f} (bound of "
              f"each {data:.4f}) on {where}", flush=True)
    elif device.type == "cpu":
        print("  K1's split: not measured (no device times on the CPU)", flush=True)
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
