"""The port's bench harness: one JSON line for programs, tables for humans.

    python -m ntt_tpu_torch bench [--m 14] [--q-bits 62] [--batch 128]
        [--reps 5] [--tile T] [--also-batch N] [--solinas-q]
        [--suite [--suite-json F] [--only NAMES] [--controls K]]
        [--budget-s 420] [--peak-gbs 3350] [--profile-dir DIR]
        [--device cuda|cpu]

The counterpart of the root ``bench.py``, on the port's API.  Headline:
forward NTT transforms/s of ``api.fwd_ntt(x, p)`` (strict, ``"auto"``) on
device tensors, N = 2^m, ``p = bench_params(m, q_bits)``, one batch of
random polynomials below q; with ``--tile T`` the same forward through
``api.DeviceNtt(p, batch_tile=T).fwd``.  ``vs_baseline`` divides it by the
single-core host C++ transform at the same (q, m) (``host_baseline``);
it is null, with the reason on stderr, where that library does not build.

Measurement (``lab.cuda_us``'s protocol on ``cuda``): warm-up calls, then
``inner`` calls captured in one CUDA graph, the replay timed between two
CUDA events, the minimum over reps: the device view.  ``inner`` comes
from a coarse reading, so that a replay lasts about ``TARGET_S``.  Beside
it stderr gets the stream view: as many back-to-back calls between two
events, the host's enqueue included, as a server sees them.  Every call
takes the same input; a CUDA graph replays every launch it captured.  On
``--device cpu`` (the tests) the host clock times the plain path.

Readings: a coarse one first, then the refined one, then one re-measure
whose spread is ``band_pct``; the value is the faster of the last two.
The whole run works under a wall-clock budget (``--budget-s``, default
420, or ``NTT_BENCH_BUDGET_S``): a daemon watchdog prints the best-so-far
line with ``degraded`` and exits 0 if the run is still working ``grace``
seconds before the budget ends.  That is the only exit 0 without a
measured line: a failed build, launch or measurement raises (non-zero
exit, no line), and so does ``--device cuda`` without a card.

The JSON line on stdout: ``metric``
(``fwd_ntt_transforms_per_sec_N2^{m}_q{bits}bit_batch{b}``), ``value``,
``unit`` (``"transforms/s"``), ``vs_baseline``, and where they apply
``band_pct``, ``degraded`` and ``also_batch{N}_tps``.  Everything else,
the card's name and power limit included, goes to stderr.

``--suite`` times every body of the JAX bench's ``_suite_bodies`` under
its name (``SUITE``) at the suite's (q, m, batch) and writes them to
``--suite-json``; a body the port refuses at that (q, m) is written as
``{"skipped": reason}``.  ``--controls K`` re-times the sixstep anchor
every K rows and writes the spread of its readings as the header's
``band_pct``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time
from typing import Callable

import numpy as np
import torch

from ntt_tpu_torch import api, host_baseline, lab
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.params import NttParams, bench_params
from ntt_tpu_torch.plan import NttPlan, get_plan

COARSE_REPS = 2
COARSE_INNER = 8  # calls a coarse reading times
TARGET_S = 0.02  # a refined reading's replay (or run of calls on the CPU) lasts about this
MAX_INNER = 1000
GRACE_S = 12.0  # the watchdog prints this long before the budget ends

# JAX body name -> (variant, what, word): the body is fwd_ntt ("fwd"),
# inv_ntt ("inv") or negacyclic_mul(x, x.roll(1, 0)) ("mul") through the
# port's API; a word-64 body runs on an int64 tensor, a word-32 one on the
# plan's int32 rep.  The API computes a variant at word 64 for any q where
# the variant is ``word64``, 'r4r2' at word 32 below 2^28 and word 64 above,
# and every other variant at the plan's word (32 below 2^30); a body whose
# word is not the API's at the suite's q is refused, as are the calls
# ``api._pick`` refuses (the JAX gates ``supports_u32_*``, q < 2^60 for the
# word-64 radix-4 family, pallas-fused beyond one block).
SUITE: dict[str, tuple[str, str, int]] = {
    "radix2-u32": ("radix2-u32", "fwd", 32),
    "sixstep-u32": ("sixstep", "fwd", 32),
    "sixstep-unord-u32": ("sixstep-unordered", "fwd", 32),
    "radix4x4-u32": ("radix4x4", "fwd", 32),
    "pallas-u32": ("pallas-fused", "fwd", 32),
    "radix4-u32": ("radix4-u32", "fwd", 32),
    "mxu": ("mxu", "fwd", 32),
    "radix2-u64": ("radix2", "fwd", 64),
    "seal-u64": ("seal", "fwd", 64),
    "sixstep-u64": ("sixstep", "fwd", 64),
    "radix4x4-u64": ("radix4x4", "fwd", 64),
    "sixstep-unord-u64": ("sixstep-unordered", "fwd", 64),
    "hexl-u64": ("hexl", "fwd", 64),
    "r2-16-u64": ("r2-16", "fwd", 64),
    "pallas-u64": ("pallas-fused", "fwd", 64),
    "radix4-u64": ("radix4", "fwd", 64),
    "radix4-vec-u64": ("radix4-vec", "fwd", 64),
    "radix4-vec-unord-u64": ("radix4-vec-unordered", "fwd", 64),
    "r4r2-u64": ("r4r2", "fwd", 64),
    "radix4-w56": ("radix4-w56", "fwd", 64),
    "inv-radix2-u32": ("radix2-u32", "inv", 32),
    "inv-radix2-u64": ("radix2", "inv", 64),
    "inv-seal-u64": ("seal", "inv", 64),
    "inv-radix4-u64": ("radix4", "inv", 64),
    "inv-r4r2-u64": ("r4r2", "inv", 64),
    "inv-radix4-w56": ("radix4-w56", "inv", 64),
    "inv-sixstep-u64": ("sixstep", "inv", 64),
    "inv-radix4x4-u64": ("radix4x4", "inv", 64),
    "inv-sixstep-unord-u64": ("sixstep-unordered", "inv", 64),
    "inv-sixstep-u32": ("sixstep", "inv", 32),
    "inv-radix4x4-u32": ("radix4x4", "inv", 32),
    "sixstep-rec-u32": ("sixstep-rec", "fwd", 32),
    "sixstep-rec-u64": ("sixstep-rec", "fwd", 64),
    "he-ctmul-u32": ("sixstep", "mul", 32),
    "he-ctmul-u64": ("sixstep", "mul", 64),
}


# ---------------------------------------------------------------------------
# wall-clock budget + watchdog (the line is always printed by the budget's end)
# ---------------------------------------------------------------------------


class _Budget:
    def __init__(self, seconds: float):
        self.t0 = time.perf_counter()
        self.total = seconds

    def remaining(self) -> float:
        return self.total - (time.perf_counter() - self.t0)


class _Run:
    """One bench run: its best-so-far result (the JAX bench's module-level
    ``_RESULT``), the one JSON line it prints, and the event that stops
    its watchdog.  A run of its own per ``main`` call, so calls in one
    process share nothing and no watchdog outlives its run."""

    def __init__(self):
        self.result: dict = {}
        self.finished = threading.Event()
        self._lock = threading.Lock()
        self._emitted = False

    def emit_json(self, expired: bool = False) -> bool:
        """Print the line unless it was printed; with expired, mark it
        ``degraded`` as the watchdog does.  True if this call printed it."""
        with self._lock:
            if self._emitted:
                return False
            self._emitted = True
            res = dict(self.result)
        if expired:
            if "value" not in res:
                res["degraded"] = "budget expired before any measurement"
            else:
                res.setdefault("degraded", "budget expired during refinement")
        line = {
            "metric": res.get("metric", "fwd_ntt_transforms_per_sec"),
            "value": res.get("value", 0.0),
            "unit": "transforms/s",
            "vs_baseline": res.get("vs_baseline"),
        }
        if res.get("band_pct") is not None:
            line["band_pct"] = res["band_pct"]
        if res.get("degraded"):
            line["degraded"] = res["degraded"]
        line.update((k, v) for k, v in res.items() if k.startswith("also_"))
        print(json.dumps(line), flush=True)
        return True


def _arm_watchdog(run: _Run, budget: _Budget, grace: float = GRACE_S) -> None:
    """Daemon thread: if the run has not finished ``grace`` seconds before
    the budget ends, print its best-so-far line and exit 0 at once.
    ``os._exit``: a call wedged in native code cannot be interrupted from
    Python, only abandoned (an open graph capture included: the process's
    exit frees its device memory)."""

    def watch():
        if run.finished.wait(max(0.0, budget.remaining() - grace)):
            return
        print(f"bench watchdog: budget {budget.total:.0f}s expired, emitting best-so-far "
              "result", file=sys.stderr, flush=True)
        if run.emit_json(expired=True):
            sys.stderr.flush()
            os._exit(0)

    threading.Thread(target=watch, daemon=True, name="bench-watchdog").start()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_us(fn, x, reps: int, inner: int) -> float:
    """One call's time on the host clock in us: inner calls after one
    warm-up call, the minimum over reps (the CPU's plain path)."""
    fn(x)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(x)
        best = min(best, (time.perf_counter() - t0) * 1e6 / inner)
    return best


def _stream_us(fn, x, reps: int, inner: int) -> float:
    """One call's time in a stream of inner back-to-back calls between two
    CUDA events, the host's enqueue included, in us; minimum over reps."""
    fn(x)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(x)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / inner)
    return best


def measure_us(fn, x, reps: int, inner: int, device: torch.device) -> float:
    """One call's time in us: on ``cuda`` the device view (``lab.cuda_us``:
    inner calls in a CUDA graph after warm-up calls, min over reps), on the
    CPU the host clock."""
    if device.type == "cuda":
        return lab.cuda_us(fn, x, reps, inner)
    return _host_us(fn, x, reps, inner)


def calibrated_inner(us: float) -> int:
    """Calls a refined reading times: about TARGET_S of them."""
    return max(COARSE_INNER, min(MAX_INNER, math.ceil(TARGET_S * 1e6 / us)))


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------


def bench_input(p: NttParams, batch: int, device: torch.device, wide: bool = False):
    """A seeded batch of random polynomials below q on ``device``: the
    plan's rep, or with wide an int64 tensor."""
    a = np.random.default_rng(0).integers(0, p.q, size=(batch, p.n), dtype=np.uint64)
    return mm.from_host(a, p.q, device, wide=wide)


def headline_call(p: NttParams, tile: int | None, device: torch.device) -> Callable:
    """The headline call on a tensor: ``api.fwd_ntt(x, p)`` (strict,
    ``"auto"``), or with tile ``api.DeviceNtt(p, batch_tile=tile).fwd``."""
    if tile:
        return api.DeviceNtt(p, batch_tile=tile, device=device).fwd
    return lambda x: api.fwd_ntt(x, p)


def metric_name(p: NttParams, batch: int) -> str:
    return f"fwd_ntt_transforms_per_sec_N2^{p.m}_q{p.q.bit_length()}bit_batch{batch}"


def _api_word(plan: NttPlan, variant: str) -> int:
    """The word the API computes ``variant`` at for this plan's q."""
    if api.get_variant(variant).word64:
        return 64
    return api._r4r2_word(plan) if variant == "r4r2" else plan.word


def suite_bodies(plan: NttPlan) -> dict[str, tuple[Callable, int] | str]:
    """Every name of ``SUITE``: (body, word) where the port runs it at this
    plan's (q, m), a body mapping a tensor to a tensor (kernels for a CUDA
    tensor, plain versions for a CPU one) on the rep of ``word``; else the
    reason the port refuses it."""
    bodies: dict[str, tuple[Callable, int] | str] = {}
    for name, (variant, what, word) in SUITE.items():
        try:
            api._pick(plan, variant, inverse=what != "fwd")
        except ValueError as refused:
            bodies[name] = str(refused)
            continue
        api_word = _api_word(plan, variant)
        if api_word != word:
            bodies[name] = (f"a word-{word} body: the API runs {variant!r} at word {api_word} "
                            f"for this {plan.q.bit_length()}-bit q")
        elif what == "fwd":
            bodies[name] = (lambda x, v=variant: api.fwd_ntt(x, plan, v)), word
        elif what == "inv":
            bodies[name] = (lambda x, v=variant: api.inv_ntt(x, plan, v)), word
        else:
            bodies[name] = (lambda x, v=variant: api.negacyclic_mul(x, x.roll(1, 0), plan, v)), word
    return bodies


# ---------------------------------------------------------------------------
# headline, suite, baseline
# ---------------------------------------------------------------------------


def headline(run: _Run, args, device: torch.device, budget: _Budget | None):
    """Quick-then-refine: a coarse reading lands in the run's result first
    (a budget expiry during refinement still reports a real number), then
    the refined reading replaces it, and a re-measure gives band_pct.
    Returns (params, us a call, calls a reading, the call, its input)."""
    p = bench_params(args.m, args.q_bits, solinas=args.solinas_q)
    fn = headline_call(p, args.tile, device)
    x = bench_input(p, args.batch, device)
    run.result["metric"] = metric_name(p, args.batch)

    hang = float(os.environ.get("NTT_BENCH_HANG_S", "0") or 0)
    if hang:  # test hook: a wedged build or launch (the watchdog test)
        time.sleep(hang)

    print("bench: warm-up + coarse headline reading...", file=sys.stderr, flush=True)
    us = measure_us(fn, x, COARSE_REPS, COARSE_INNER, device)
    run.result["value"] = round(args.batch / us * 1e6, 1)
    run.result["degraded"] = "coarse measurement only"
    inner = calibrated_inner(us)
    print(f"bench: coarse headline {args.batch / us * 1e6:,.0f} tps; refining with {inner} "
          "calls a reading...", file=sys.stderr, flush=True)
    if budget is None or budget.remaining() > 60:
        us = measure_us(fn, x, args.reps, inner, device)
        run.result["value"] = round(args.batch / us * 1e6, 1)
        run.result.pop("degraded", None)
        # the device has slow spells: re-measure once and keep the faster
        # reading, their spread annotating the value
        if budget is None or budget.remaining() > 90:
            again = measure_us(fn, x, args.reps, inner, device)
            run.result["band_pct"] = round(abs(again - us) / min(again, us) * 100, 1)
            if again < us:
                us = again
                run.result["value"] = round(args.batch / us * 1e6, 1)
    return p, us, inner, fn, x


def host_baseline_tps(p: NttParams, quick: bool) -> float | None:
    """The single-core host C++ transform's rate at the same (q, m), or
    None (the reason on stderr) where its library does not build."""
    try:
        ns = host_baseline.bench_fwd_lazy64_ns(p.m, p.q, p.w, inner=20 if quick else 100,
                                               reps=3 if quick else 10)
    except (RuntimeError, OSError, subprocess.SubprocessError) as refused:
        print(f"bench: no host baseline: {refused}", file=sys.stderr, flush=True)
        return None
    return 1e9 / ns


def suite(args, device: torch.device, budget: _Budget | None) -> dict:
    """Every SUITE body timed at (q, m, batch), refused ones marked;
    written to args.suite_json (the per-variant table on stderr)."""
    p = bench_params(args.m, args.q_bits, solinas=args.solinas_q)
    plan = get_plan(p)
    bodies = suite_bodies(plan)
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - set(bodies)
        if unknown:
            raise SystemExit(f"unknown suite bodies {sorted(unknown)}; have {sorted(bodies)}")
        bodies = {k: v for k, v in bodies.items() if k in keep}
    inputs = {64: bench_input(p, args.batch, device, wide=True)}
    if plan.word == 32:
        inputs[32] = bench_input(p, args.batch, device)
    print(f"variant timings at q={p.q:#x} ({p.q.bit_length()}-bit), N=2^{p.m}, "
          f"batch={args.batch}, on {where(device)}:", file=sys.stderr, flush=True)

    def timed_us(fn, x):
        inner = calibrated_inner(measure_us(fn, x, COARSE_REPS, COARSE_INNER, device))
        return measure_us(fn, x, args.reps, inner, device)

    # interleaved control: re-time one anchor body every --controls rows;
    # the spread of its readings bounds the drift every row is subject to
    control_name = next((n for n in ("sixstep-u64", "sixstep-u32")
                         if not isinstance(bodies.get(n, ""), str)), None)
    controls: list[dict] = []

    def control(after: int) -> None:
        if control_name is None or args.controls <= 0:
            return
        if budget is not None and budget.remaining() < 25:
            return
        fn, word = bodies[control_name]
        us = timed_us(fn, inputs[word]) / args.batch
        controls.append({"after_row": after, "us_per_transform": round(us, 3)})
        print(f"  [control] {control_name:10s} {us:8.2f} us/transform", file=sys.stderr,
              flush=True)

    results: dict[str, dict] = {}
    control(0)
    for i, (name, body) in enumerate(sorted(bodies.items()), start=1):
        if isinstance(body, str):
            results[name] = {"skipped": body}
            print(f"  {name:22s} skipped ({body})", file=sys.stderr, flush=True)
        elif budget is not None and budget.remaining() < 25:
            results[name] = {"skipped": "budget"}
            print(f"  {name:22s} skipped (budget)", file=sys.stderr, flush=True)
        else:
            fn, word = body
            us = timed_us(fn, inputs[word]) / args.batch
            results[name] = {"us_per_transform": round(us, 3), "tps": round(1e6 / us, 1)}
            print(f"  {name:22s} {us:8.2f} us/transform ({1e6 / us:12,.0f} tps)",
                  file=sys.stderr, flush=True)
        if args.controls > 0 and i % args.controls == 0 and i < len(bodies):
            control(i)
    control(len(bodies))
    header: dict = {"q": hex(p.q), "m": p.m, "batch": args.batch}
    if controls:
        us = [c["us_per_transform"] for c in controls]
        header["control"] = {"name": control_name, "readings": controls,
                             "band_pct": round((max(us) - min(us)) / min(us) * 100, 1)}
        print(f"  control band ({control_name}): {min(us):.2f}-{max(us):.2f} us/t "
              f"({header['control']['band_pct']}%)", file=sys.stderr, flush=True)
    table = {**header, "variants": results}
    with open(args.suite_json, "w") as f:
        json.dump(table, f, indent=1)
    print(f"suite JSON written to {args.suite_json}", file=sys.stderr, flush=True)
    return table


def roofline(p: NttParams, us_per_transform: float, word: int, peak_gbs: float) -> str:
    """Achieved memory rate against one read and one write of the
    coefficients a transform (the bytes bound), and against one pass a
    radix-2 stage."""
    bytes_min = 2 * p.n * word // 8
    gbs = bytes_min / us_per_transform / 1e3
    return (f"roofline: {gbs:.1f} GB/s on the 2-pass model ({100 * gbs / peak_gbs:.1f}% of "
            f"{peak_gbs:.0f} GB/s peak); per-stage model {gbs * p.m:.0f} GB/s "
            f"({100 * gbs * p.m / peak_gbs:.0f}% of peak)")


def where(device: torch.device) -> str:
    """The card's name and power limit, or what runs on the CPU."""
    return lab.card(device) if device.type == "cuda" else "the CPU (plain path, host clock)"


def profile(args, device: torch.device, out_dir: str) -> None:
    """A torch.profiler trace (CPU and CUDA activities) of one headline
    call after warm-up, exported as a Chrome trace into out_dir."""
    p = bench_params(args.m, args.q_bits, solinas=args.solinas_q)
    fn = headline_call(p, args.tile, device)
    x = bench_input(p, args.batch, device)
    for _ in range(2):
        fn(x)
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn(x)
        _sync(device)
    path = pathlib.Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "headline_trace.json"))
    print(f"profiler trace written to {path / 'headline_trace.json'}", file=sys.stderr,
          flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ntt_tpu_torch bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--tile", type=int, default=None,
                    help="run the headline through api.DeviceNtt(p, batch_tile=TILE).fwd")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--m", type=int, default=14)
    ap.add_argument("--q-bits", type=int, default=62)
    ap.add_argument("--solinas-q", action="store_true",
                    help="the modulus of find_solinas_ntt_prime in place of the largest prime "
                    "(the same q at the m14 headline)")
    ap.add_argument("--budget-s", type=float,
                    default=float(os.environ.get("NTT_BENCH_BUDGET_S", "420")),
                    help="wall-clock budget; the JSON line is printed before it ends "
                    "(<= 0 disables the watchdog)")
    ap.add_argument("--suite", action="store_true")
    ap.add_argument("--suite-json", default="bench_suite.json",
                    help="where --suite writes its per-variant JSON table")
    ap.add_argument("--controls", type=int, default=6,
                    help="suite: re-time the sixstep anchor every K rows (0 disables)")
    ap.add_argument("--only", default=None, help="comma list of suite bodies to time")
    ap.add_argument("--also-batch", type=int, default=None,
                    help="also time this batch (coarse reading) as also_batch{N}_tps")
    ap.add_argument("--peak-gbs", type=float, default=3350.0,
                    help="memory peak for the roofline line (H100 SXM HBM3)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of one headline call here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the transforms run (cpu: their plain PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None, grace: float = GRACE_S) -> int:
    args = parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                               "pass --device cpu to time the plain path")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    run = _Run()
    budget = _Budget(args.budget_s) if args.budget_s > 0 else None
    if budget is not None:
        _arm_watchdog(run, budget, grace)
    try:
        card = where(device)
        print(f"bench: torch {torch.__version__} on {card}", file=sys.stderr, flush=True)
        if args.suite:
            suite(args, device, budget)
        if args.profile_dir:
            profile(args, device, args.profile_dir)
        p, us, inner, fn, x = headline(run, args, device, budget)
        tps = args.batch / us * 1e6
        if args.also_batch and args.also_batch != args.batch and (
                budget is None or budget.remaining() > 90):
            x2 = bench_input(p, args.also_batch, device)
            us2 = measure_us(headline_call(p, None, device), x2, COARSE_REPS, COARSE_INNER,
                             device)
            run.result[f"also_batch{args.also_batch}_tps"] = round(args.also_batch / us2 * 1e6, 1)
            print(f"bench: batch={args.also_batch} row: {args.also_batch / us2 * 1e6:,.0f} "
                  f"transforms/s ({us2 / args.also_batch:.3f} us/t)", file=sys.stderr,
                  flush=True)
        if budget is None or budget.remaining() > 45:
            base = host_baseline_tps(p, quick=device.type == "cpu")
        else:
            print("bench: skipping host baseline (budget)", file=sys.stderr, flush=True)
            base = None
        vs = round(tps / base, 3) if base else None
        run.result["vs_baseline"] = vs

        line = (f"bench: {card}: q={p.q:#x} N=2^{p.m} batch={args.batch}: {tps:,.0f} "
                f"transforms/s ({us:.1f} us a call, {inner} calls a reading), "
                f"{us / args.batch / (p.n // 2 * p.m) * 1e3:.3g} ns/butterfly")
        if base:
            line += f"; host-CPU baseline {base:,.0f}/s -> {vs:.3g}x"
        print(line, file=sys.stderr, flush=True)
        if device.type == "cuda":
            s_us = _stream_us(fn, x, args.reps, inner)
            print(f"bench: stream view ({inner} back-to-back calls between CUDA events, the "
                  f"host's enqueue included): {s_us:.1f} us a call "
                  f"({args.batch / s_us * 1e6:,.0f} transforms/s)", file=sys.stderr, flush=True)
            print(roofline(p, us / args.batch, get_plan(p).word, args.peak_gbs),
                  file=sys.stderr, flush=True)
        else:
            print("roofline: not measured (the plain path on the CPU)", file=sys.stderr,
                  flush=True)
        run.emit_json()
    finally:
        run.finished.set()
    return 0
