#!/usr/bin/env python3
"""Drive the ntt_tpu_torch main path once on one CUDA card.

    python chip_smoke.py [--seed SEED]

Phases, each of which raises on failure (nothing is caught):

1. device: require a CUDA card; print its name and power limit;
2. build: compile the CUDA kernels of ntt_tpu_torch/csrc with nvcc for
   sm_90a, print the time and ptxas's register report;
3. kernel vs plain: at N = 2^14, batch 128, for a 62-bit q and a q < 2^30,
   run K1 (fwd_fused, strict and lazy), K2 (inv_fused) and K3 (mul_mod) on
   the card and require each output to equal, bit for bit, the plain
   PyTorch version run on the same CUDA tensors; check two rows of each
   against exact big-int arithmetic on the host;
4. main path: with every launch count set to 0, the HE batch of 1024
   polynomials through api.negacyclic_mul and a batch-128 round trip
   inv_ntt(fwd_ntt(a)) == a, at both widths; the products must equal the
   plain path's and, at sampled coefficients, the schoolbook negacyclic
   convolution; every kernel must have been launched;
5. times: CUDA events, warm-up, minimum over repetitions, kernel and plain
   version in turns, beside the card's name and power limit.

The last two lines before the final one are the nvidia-smi line and the
kernel table as JSON; the final line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA card or outside the
repository.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BATCH_CHECK = 128
BATCH_HE = 1024
CASES = ("q62", "q29")  # bench_params(14, 62) and FIXTURES[9] (q = 0x1FFC8001)
SOURCES = {"fwd_fused": "ntt_tpu_torch/csrc/ntt_fused.cu",
           "inv_fused": "ntt_tpu_torch/csrc/ntt_fused.cu",
           "mul_mod": "ntt_tpu_torch/csrc/pointwise.cu"}
REPLACES = {"fwd_fused": "ntt_tpu/kernels/pallas_fused.py:230",
            "inv_fused": "ntt_tpu/kernels/pallas_fused.py:257",
            "mul_mod": "ntt_tpu/api.py:1517"}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Minimum over reps of one call's time between two CUDA events."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def in_turns(torch, kernel, plain, reps_k: int, reps_p: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, reps_p)
    k1 = cuda_ms(torch, kernel, reps_k)
    k2 = cuda_ms(torch, kernel, reps_k)
    p2 = cuda_ms(torch, plain, reps_p)
    return min(k1, k2), min(p1, p2)


def bitrev(j: int, bits: int) -> int:
    return int(format(j, f"0{bits}b")[::-1], 2)


def direct_ntt_at(row, j: int, p) -> int:
    """Output j of the negacyclic NTT by its definition:
    sum_i a_i * psi^(i * (2 * bitrev(j) + 1)) mod q."""
    base = pow(p.w, 2 * bitrev(j, p.m) + 1, p.q)
    acc, cur = 0, 1
    for x in row:
        acc += int(x) * cur
        cur = cur * base % p.q
    return acc % p.q


def schoolbook_at(a, b, k: int, p) -> int:
    """Coefficient k of a * b in Z_q[X]/(X^N + 1), by the definition."""
    n = p.n
    acc = sum(int(a[i]) * int(b[k - i]) for i in range(k + 1))
    acc -= sum(int(a[i]) * int(b[n + k - i]) for i in range(k + 1, n))
    return acc % p.q


def max_abs_err(np, got, want) -> int:
    """Largest |got - want| over two uint64 arrays."""
    return int(np.where(got > want, got - want, want - got).max()) if got.size else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (ROOT / "ntt_tpu_torch" / "csrc").is_dir():
        print(f"ntt_tpu_torch/ not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ntt_tpu_torch import FIXTURES, api, bench_params, native
    from ntt_tpu_torch import modmath as mm
    from ntt_tpu_torch.kernels import fused, pointwise, sixstep
    from ntt_tpu_torch.kernels.elems import pick_ops
    from ntt_tpu_torch.plan import get_plan

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s); nvidia-smi: {smi}", flush=True)

    phase("build")
    res = native.build()
    native.lib()
    print(f"library {res.path.name}: nvcc {res.seconds:.1f} s"
          + (" (already built)" if not res.log else ""), flush=True)
    for line in res.log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())

    params = {"q62": bench_params(14, 62), "q29": FIXTURES[9]}
    rng = np.random.default_rng(args.seed)
    errs: dict[str, int] = {}

    def rand(p, batch):
        host = rng.integers(0, p.q, size=(batch, p.n), dtype=np.uint64)
        return mm.from_host(host, p.q, dev)

    def note(name, got, want, what):
        err = max_abs_err(np, mm.to_host(got), mm.to_host(want))
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from the plain version "
                                 f"(max abs err {err})")
        errs[name] = max(errs.get(name, 0), err)
        print(f"  {what}: equal to plain ({tuple(got.shape)})", flush=True)

    phase(f"kernel vs plain, batch {BATCH_CHECK}")
    for case in CASES:
        p = params[case]
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        inv_c = plan.inv_consts
        word = f"u{plan.word}"
        a, b = rand(p, BATCH_CHECK), rand(p, BATCH_CHECK)
        k1 = fused.fwd_fused(a, plan, strict=True)
        note(f"fwd_fused_{word}", k1, sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q),
             f"{case} K1 fwd_fused strict")
        k1l = fused.fwd_fused(a, plan, strict=False)
        note(f"fwd_fused_{word}", k1l,
             sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q, strict=False),
             f"{case} K1 fwd_fused lazy")
        k2 = fused.inv_fused(k1, plan)
        note(f"inv_fused_{word}", k2,
             sixstep.inv_sixstep(k1, ops, tabs.w_inv, tabs.w_inv_con, *inv_c, p.q),
             f"{case} K2 inv_fused")
        if not torch.equal(k2, a):
            raise AssertionError(f"{case}: inv_fused(fwd_fused(a)) != a")
        # K2's branch for a final-stage Shoup constant one bit wider than the
        # word: no params produce one (tmp = n_inv * w_inv[1] lands below q),
        # so the launcher is driven directly with a lazy tmp in [q, 2q)
        tmp_w = p.q + 12345
        con_w = (tmp_w << plan.word) // p.q
        wide = torch.empty_like(k1)
        native.launch(f"inv_fused_{word}", k1.data_ptr(), wide.data_ptr(),
                      tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), p.q, inv_c[0],
                      inv_c[1], tmp_w, con_w & ((1 << plan.word) - 1),
                      con_w >> plan.word, BATCH_CHECK, p.m, native.stream(dev))
        note(f"inv_fused_{word}", wide,
             sixstep.inv_sixstep(k1, ops, tabs.w_inv, tabs.w_inv_con, inv_c[0], inv_c[1],
                                 tmp_w, con_w, p.q),
             f"{case} K2 inv_fused with a {plan.word + 1}-bit final constant")
        k3 = pointwise.mul_mod(a, b, p.q)
        note(f"mul_mod_{word}", k3, ops.mul_mod(a, b, p.q), f"{case} K3 mul_mod")
        torch.cuda.synchronize()
        ha, hb, h1, hl, h3 = (mm.to_host(t[:2]) for t in (a, b, k1, k1l, k3))
        js = sorted({0, 1, p.n // 2, p.n - 1, *rng.integers(0, p.n, 4).tolist()})
        for r in range(2):
            for j in js:
                want = direct_ntt_at(ha[r], j, p)
                if int(h1[r, j]) != want or int(hl[r, j]) % p.q != want:
                    raise AssertionError(f"{case} row {r} output {j}: NTT by definition "
                                         f"gives {want}, K1 gave {int(h1[r, j])}")
            if any(int(x) * int(y) % p.q != int(z) for x, y, z in zip(ha[r], hb[r], h3[r])):
                raise AssertionError(f"{case} row {r}: K3 differs from Python ints")
        print(f"  {case}: two rows of K1 (strict, lazy mod q) at outputs {js} match the "
              "NTT by definition; K3 rows match Python ints; inv_fused(fwd_fused(a)) == a",
              flush=True)

    phase(f"main path: negacyclic_mul at batch {BATCH_HE}, round trip at batch {BATCH_CHECK}")
    he = {case: (rand(params[case], BATCH_HE), rand(params[case], BATCH_HE)) for case in CASES}
    rt = {case: rand(params[case], BATCH_CHECK) for case in CASES}
    torch.cuda.synchronize()
    for counts in (fused.LAUNCHES, pointwise.LAUNCHES):
        for k in counts:
            counts[k] = 0
    prod, back = {}, {}
    for case in CASES:
        p = params[case]
        prod[case] = api.negacyclic_mul(*he[case], p)
        back[case] = api.inv_ntt(api.fwd_ntt(rt[case], p), p)
    torch.cuda.synchronize()
    launches = {**fused.LAUNCHES, **pointwise.LAUNCHES}
    print(f"  launch counts of the main path: {launches}", flush=True)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the main path: {idle}")

    def plain_product(p, x, y):
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        fx = sixstep.fwd_sixstep(x, ops, tabs.w, tabs.w_con, p.q)
        fy = sixstep.fwd_sixstep(y, ops, tabs.w, tabs.w_con, p.q)
        return sixstep.inv_sixstep(ops.mul_mod(fx, fy, p.q), ops, tabs.w_inv,
                                   tabs.w_inv_con, *plan.inv_consts, p.q)

    for case in CASES:
        p = params[case]
        x, y = he[case]
        if not torch.equal(back[case], rt[case]):
            raise AssertionError(f"{case}: inv_ntt(fwd_ntt(a)) != a")
        want = plain_product(p, x, y)
        if not torch.equal(prod[case], want):
            raise AssertionError(f"{case}: negacyclic_mul differs from the plain path")
        hx, hy, hp = (mm.to_host(t[:2]) for t in (x, y, prod[case]))
        ks = sorted({0, 1, p.n - 1, *rng.integers(0, p.n, 3).tolist()})
        for r in range(2):
            for k in ks:
                if int(hp[r, k]) != schoolbook_at(hx[r], hy[r], k, p):
                    raise AssertionError(f"{case} row {r} coeff {k}: product differs "
                                         "from the schoolbook convolution")
        print(f"  {case}: negacyclic_mul {tuple(x.shape)} equals the plain path and, at "
              f"coefficients {ks} of two rows, the schoolbook product; round trip "
              f"{tuple(rt[case].shape)} exact", flush=True)
        del want

    phase(f"times (CUDA events, min over reps; {smi})")
    table = []
    for case in CASES:
        p = params[case]
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        inv_c = plan.inv_consts
        word = f"u{plan.word}"
        x, y = he[case]
        fx = fused.fwd_fused(x, plan)
        small = rt[case]
        k_ms, p_ms = in_turns(
            torch, lambda: fused.fwd_fused(small, plan),
            lambda: sixstep.fwd_sixstep(small, ops, tabs.w, tabs.w_con, p.q), 20, 3)
        print(f"  {case} K1 fwd_fused batch {BATCH_CHECK}: kernel {k_ms * 1e3:.1f} us "
              f"({BATCH_CHECK / k_ms * 1e3:,.0f} transforms/s), plain {p_ms * 1e3:.1f} us "
              f"({BATCH_CHECK / p_ms * 1e3:,.0f} transforms/s)", flush=True)
        runs = {
            f"fwd_fused_{word}": (lambda: fused.fwd_fused(x, plan),
                                  lambda: sixstep.fwd_sixstep(x, ops, tabs.w, tabs.w_con, p.q)),
            f"inv_fused_{word}": (lambda: fused.inv_fused(fx, plan),
                                  lambda: sixstep.inv_sixstep(fx, ops, tabs.w_inv,
                                                              tabs.w_inv_con, *inv_c, p.q)),
            f"mul_mod_{word}": (lambda: pointwise.mul_mod(x, y, p.q),
                                lambda: ops.mul_mod(x, y, p.q)),
        }
        for name, (kern, plain) in runs.items():
            k_ms, p_ms = in_turns(torch, kern, plain, 10, 2)
            base = name.rsplit("_", 1)[0]
            table.append({"name": name, "route": "cuda", "source": SOURCES[base],
                          "replaces": REPLACES[base], "launches": launches[name],
                          "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms})
            print(f"  {case} {name} batch {BATCH_HE}: kernel {k_ms * 1e3:.1f} us "
                  f"({BATCH_HE / k_ms * 1e3:,.0f} polys/s), plain {p_ms * 1e3:.1f} us",
                  flush=True)
        k_ms, p_ms = in_turns(torch, lambda: api.negacyclic_mul(x, y, p),
                              lambda: plain_product(p, x, y), 5, 2)
        print(f"  {case} negacyclic_mul batch {BATCH_HE}: kernels {k_ms * 1e3:.1f} us "
              f"({BATCH_HE / k_ms * 1e3:,.0f} products/s), plain {p_ms * 1e3:.1f} us "
              f"({BATCH_HE / p_ms * 1e3:,.0f} products/s)", flush=True)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
