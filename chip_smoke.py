#!/usr/bin/env python3
"""Drive the ntt_tpu_torch main path once on one CUDA card.

    python chip_smoke.py [--seed SEED]

Phases, each of which raises on failure (nothing is caught):

1. device: require a CUDA card; print its name and power limit;
2. build: compile the CUDA kernels of ntt_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc per source, all started together; print the time and
   ptxas's register report;
3. kernel vs plain: at N = 2^14, batch 128, for a 62-bit q and a q < 2^30,
   run K1 (fwd_fused, strict and lazy), K2 (inv_fused) and K3 (mul_mod) on
   the card and require each output to equal, bit for bit, the plain
   PyTorch version run on the same CUDA tensors; check two rows of each
   against exact big-int arithmetic on the host;
4. main path within one block: with every launch count set to 0, the HE
   batch of 1024 polynomials through api.negacyclic_mul and a batch-128
   round trip inv_ntt(fwd_ntt(a)) == a, at both widths; the products must
   equal the plain path's and, at sampled coefficients, the schoolbook
   negacyclic convolution; K1, K2 and K3 must have been launched;
5. two-pass kernels vs plain: K4 (fwd_cols), K5 (fwd_rows, strict and
   lazy, both output layouts), K6 (inv_rows, both input layouts) and K7
   (inv_cols, also with a final-stage constant one bit wider than the
   word) against their plain versions, bit for bit, at N = 2^16 batch 128
   and N = 2^20 batch 16 at both widths and N = 2^24 batch 1 at 62 bits;
   at N = 2^16 two rows of the forward against the NTT by its definition;
6. main path beyond one block: with every launch count set to 0, the CKKS
   product of 128 residue polynomials at N = 2^16 (both widths), round
   trips at N = 2^20 (batch 16, both widths) and N = 2^24 (batch 1), and
   the reference fixtures 15 to 18 through 'auto'; products equal to the
   plain path's and to the schoolbook product at sampled coefficients,
   round trips exact; K4 to K7 must have been launched at both widths;
7. times: CUDA events, warm-up, minimum over repetitions, kernel and plain
   version in turns, beside the card's name and power limit; each kernel's
   bound, the larger of its bytes over the memory rate and its integer
   multiplies over the multiply rate.

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

ROOT = pathlib.Path(__file__).resolve().parent
BATCH_CHECK = 128
BATCH_HE = 1024
CASES = ("q62", "q29")  # bench_params(14, 62) and FIXTURES[9] (q = 0x1FFC8001)
# two-pass sizes: (name, batch); m16: CKKS at N = 2^16, 128 residues;
# m20 / m24: the single-GPU sizes of BASELINE.json configs[4]
TWO_PASS = (("m16-q62", 128), ("m16-q29", 128), ("m20-q62", 16), ("m20-q29", 16),
            ("m24-q62", 1))
FIXTURES_BEYOND = (15, 16, 17, 18)
CSRC = "ntt_tpu_torch/csrc/"
SOURCES = {"fwd_fused": CSRC + "ntt_fused.cu", "inv_fused": CSRC + "ntt_fused.cu",
           "mul_mod": CSRC + "pointwise.cu", "fwd_cols": CSRC + "ntt_sixstep.cu",
           "fwd_rows": CSRC + "ntt_sixstep.cu", "inv_rows": CSRC + "ntt_sixstep.cu",
           "inv_cols": CSRC + "ntt_sixstep.cu"}
REPLACES = {"fwd_fused": "ntt_tpu/kernels/pallas_fused.py:230",
            "inv_fused": "ntt_tpu/kernels/pallas_fused.py:257",
            "mul_mod": "ntt_tpu/api.py:1517",
            "fwd_cols": "ntt_tpu/kernels/sixstep.py:259",
            "fwd_rows": "ntt_tpu/kernels/sixstep.py:294",
            "inv_rows": "ntt_tpu/kernels/pallas_fused.py:286",
            "inv_cols": "ntt_tpu/kernels/pallas_fused.py:307"}
# The card's rates for the bound (NVIDIA H100 SXM data sheet, 700 W): HBM3 at
# 3.35 TB/s; 67 TFLOP/s of float32 are 128 fused multiply-adds per SM per
# clock, and Hopper issues 32-bit integer multiply-adds at half that (CUDA
# C++ Programming Guide, arithmetic instruction throughput): 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 67e12 / 4
# 32-bit multiplies of one Shoup product (hi(w_con*t), w*t, Q*q): one each at
# word 32; at word 64 a 64x64 high half takes four partial products and each
# low half three.  mul_mod: the full product, then folds (pointwise.cu).
SHOUP_MULS = {32: 3, 64: 10}
MUL_MOD_MULS = {32: 6, 64: 34}


def kernel_work(kernel: str, m: int, n1_log: int, batch: int, word: int):
    """(bytes, 32-bit multiplies) one launch must move and do: each input
    read once (the twiddle entries it uses included), each output written
    once."""
    n, size = 1 << m, word // 8
    data = 2 * batch * n * size
    bfly = batch * n // 2 * SHOUP_MULS[word]  # one stage
    n1 = 1 << n1_log
    return {
        "fwd_fused": (data + 2 * n * size, bfly * m),
        "inv_fused": (data + 2 * n * size, bfly * (m + 1)),  # final stage: two
        "mul_mod": (3 * batch * n * size, batch * n * MUL_MOD_MULS[word]),
        "fwd_cols": (data + 2 * n1 * size, bfly * n1_log),
        "inv_cols": (data + 2 * n1 * size, bfly * (n1_log + 1)),
        "fwd_rows": (data + 2 * (n - n1) * size, bfly * (m - n1_log)),
        "inv_rows": (data + 2 * (n - n1) * size, bfly * (m - n1_log)),
    }[kernel]


def bound(nbytes: int, muls: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, muls / INT_MULS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
    from ntt_tpu_torch import FIXTURES, NttParams, api, bench_params, native
    from ntt_tpu_torch import modmath as mm
    from ntt_tpu_torch.kernels import fused, pointwise, sixstep, twopass
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

    def rand(p, batch, hi=None):
        host = rng.integers(0, hi or p.q, size=(batch, p.n), dtype=np.uint64)
        return mm.from_host(host, p.q, dev)

    def check_ntt_rows(p, a, f, lazy, what):
        """Two rows of a forward output (strict f, lazy mod q) at sampled
        outputs against the NTT by its definition."""
        torch.cuda.synchronize()
        ha, hf, hl = (mm.to_host(t[:2]) for t in (a, f, lazy))
        js = sorted({0, 1, p.n // 2, p.n - 1, *rng.integers(0, p.n, 4).tolist()})
        for r in range(min(2, len(ha))):
            for j in js:
                want = direct_ntt_at(ha[r], j, p)
                if int(hf[r, j]) != want or int(hl[r, j]) % p.q != want:
                    raise AssertionError(f"{what} row {r} output {j}: NTT by definition "
                                         f"gives {want}, the kernel {int(hf[r, j])}")
        return js

    def check_product_rows(p, x, y, prod, what):
        """Two rows of a product at sampled coefficients against the
        schoolbook convolution."""
        hx, hy, hp = (mm.to_host(t[:2]) for t in (x, y, prod))
        ks = sorted({0, 1, p.n - 1, *rng.integers(0, p.n, 3).tolist()})
        for r in range(2):
            for k in ks:
                if int(hp[r, k]) != schoolbook_at(hx[r], hy[r], k, p):
                    raise AssertionError(f"{what} row {r} coeff {k}: product differs "
                                         "from the schoolbook convolution")
        return ks

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
        js = check_ntt_rows(p, a, k1, k1l, f"{case} K1")
        ha, hb, h3 = (mm.to_host(t[:2]) for t in (a, b, k3))
        for r in range(2):
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
        ks = check_product_rows(p, x, y, prod[case], case)
        print(f"  {case}: negacyclic_mul {tuple(x.shape)} equals the plain path and, at "
              f"coefficients {ks} of two rows, the schoolbook product; round trip "
              f"{tuple(rt[case].shape)} exact", flush=True)
        del want

    tp_params = {"m16-q62": bench_params(16, 62), "m16-q29": NttParams.generate(29, 16),
                 "m20-q62": bench_params(20, 62), "m20-q29": NttParams.generate(29, 20),
                 "m24-q62": bench_params(24, 62)}

    def two_pass_ops(size):
        p = tp_params[size]
        plan = get_plan(p)
        return p, plan, pick_ops(p.q), plan.device_tables(dev), \
            sixstep.word_split(p.n, plan.word), f"u{plan.word}"

    phase("two-pass kernels vs plain: " + ", ".join(f"{s} batch {b}" for s, b in TWO_PASS))
    for size, batch in TWO_PASS:
        p, plan, ops, tabs, n1, word = two_pass_ops(size)
        tag = f"{size} (n1_log {n1})"
        a = rand(p, batch)
        k4 = twopass.fwd_cols(a, plan, n1)
        note(f"fwd_cols_{word}", k4, sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q, n1),
             f"{tag} K4 fwd_cols")
        lazy_in = rand(p, batch, hi=4 * p.q)
        note(f"fwd_cols_{word}", twopass.fwd_cols(lazy_in, plan, n1),
             sixstep.fwd_cols(lazy_in, ops, tabs.w, tabs.w_con, p.q, n1),
             f"{tag} K4 fwd_cols on lazy input < 4q")
        del lazy_in
        k5 = {}
        for strict in (True, False):
            for keep_t in (False, True):
                k5[strict, keep_t] = twopass.fwd_rows(k4, plan, n1, strict, keep_t)
                note(f"fwd_rows_{word}", k5[strict, keep_t],
                     sixstep.fwd_rows(k4, ops, tabs.w, tabs.w_con, p.q, n1, strict, keep_t),
                     f"{tag} K5 fwd_rows {'strict' if strict else 'lazy'}"
                     f"{', kept transposed' if keep_t else ''}")
        k6 = twopass.inv_rows(k5[True, False], plan, n1)
        note(f"inv_rows_{word}", k6, sixstep.inv_rows(k5[True, False], ops, tabs.w_inv,
                                                      tabs.w_inv_con, p.q, n1),
             f"{tag} K6 inv_rows")
        k6t = twopass.inv_rows(k5[True, True], plan, n1, input_transposed=True)
        note(f"inv_rows_{word}", k6t, sixstep.inv_rows(k5[True, True], ops, tabs.w_inv,
                                                       tabs.w_inv_con, p.q, n1, True),
             f"{tag} K6 inv_rows from the transposed layout")
        if not torch.equal(k6, k6t):
            raise AssertionError(f"{tag}: K6 differs between the two input layouts")
        k7 = twopass.inv_cols(k6, plan, n1)
        n_inv, n_inv_con, f_tmp, f_con = plan.inv_consts
        note(f"inv_cols_{word}", k7, sixstep.inv_cols(k6, ops, tabs.w_inv, tabs.w_inv_con,
                                                      n_inv, n_inv_con, f_tmp, f_con, p.q, n1),
             f"{tag} K7 inv_cols")
        if not torch.equal(k7, a):
            raise AssertionError(f"{tag}: K7(K6(K5(K4(a)))) != a")
        # K7's branch for a final-stage constant one bit wider than the word,
        # driven directly as K2's is above
        tmp_w = p.q + p.q // 3
        con_w = (tmp_w << plan.word) // p.q
        wide = torch.empty_like(k6)
        tc = twopass.tile_log(n1, p.m - n1, plan.word, rows=False)
        native.launch(f"inv_cols_{word}", k6.data_ptr(), wide.data_ptr(),
                      tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), p.q, n_inv,
                      n_inv_con, tmp_w, con_w & ((1 << plan.word) - 1), con_w >> plan.word,
                      batch, n1, p.m - n1, tc, native.stream(dev))
        note(f"inv_cols_{word}", wide,
             sixstep.inv_cols(k6, ops, tabs.w_inv, tabs.w_inv_con, n_inv, n_inv_con, tmp_w,
                              con_w, p.q, n1),
             f"{tag} K7 inv_cols with a {plan.word + 1}-bit final constant")
        if p.m <= 17:
            js = check_ntt_rows(p, a, k5[True, False], k5[False, False], tag)
            print(f"  {tag}: two rows of K4 + K5 (strict, lazy mod q) at outputs {js} match "
                  "the NTT by definition", flush=True)
        del a, k4, k5, k6, k6t, k7, wide
        torch.cuda.empty_cache()

    phase("main path beyond one block: negacyclic_mul m16 batch 128, round trips m20 "
          "batch 16 and m24 batch 1, fixtures 15-18 through 'auto'")
    he2 = {s: (rand(tp_params[s], 128), rand(tp_params[s], 128))
           for s in ("m16-q62", "m16-q29")}
    rt2 = {s: rand(tp_params[s], b) for s, b in TWO_PASS if not s.startswith("m16")}
    fx2 = {i: rand(FIXTURES[i], 4) for i in FIXTURES_BEYOND}
    torch.cuda.synchronize()
    for counts in (fused.LAUNCHES, pointwise.LAUNCHES, twopass.LAUNCHES):
        for k in counts:
            counts[k] = 0
    prod2 = {s: api.negacyclic_mul(x, y, tp_params[s]) for s, (x, y) in he2.items()}
    back2 = {s: api.inv_ntt(api.fwd_ntt(a, tp_params[s]), tp_params[s])
             for s, a in rt2.items()}
    fwd2 = {i: api.fwd_ntt(a, FIXTURES[i]) for i, a in fx2.items()}
    back_fx = {i: api.inv_ntt(f, FIXTURES[i]) for i, f in fwd2.items()}
    torch.cuda.synchronize()
    launches2 = {**twopass.LAUNCHES, **pointwise.LAUNCHES}
    print(f"  launch counts of this path: {launches2}", flush=True)
    idle = [k for k, v in launches2.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the main path: {idle}")
    if any(fused.LAUNCHES.values()):
        raise AssertionError("the path beyond one block launched a fused kernel")
    for s, (x, y) in he2.items():
        p = tp_params[s]
        if not torch.equal(prod2[s], plain_product(p, x, y)):
            raise AssertionError(f"{s}: negacyclic_mul differs from the plain path")
        ks = check_product_rows(p, x, y, prod2[s], s)
        print(f"  {s}: negacyclic_mul {tuple(x.shape)} equals the plain path and, at "
              f"coefficients {ks} of two rows, the schoolbook product", flush=True)
    for s, a in rt2.items():
        if not torch.equal(back2[s], a):
            raise AssertionError(f"{s}: inv_ntt(fwd_ntt(a)) != a")
        print(f"  {s}: round trip {tuple(a.shape)} exact", flush=True)
    for i, a in fx2.items():
        p = FIXTURES[i]
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        if not torch.equal(fwd2[i], sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q)):
            raise AssertionError(f"fixture {i}: fwd_ntt differs from the plain path")
        if not torch.equal(back_fx[i], a):
            raise AssertionError(f"fixture {i}: inv_ntt(fwd_ntt(a)) != a")
        js = check_ntt_rows(p, a, fwd2[i], fwd2[i], f"fixture {i}")
        print(f"  fixture {i} (m {p.m}, q {p.q:#x}): fwd_ntt equals the plain path and, at "
              f"outputs {js} of two rows, the NTT by definition; round trip exact",
              flush=True)
    del prod2, back2, fwd2, back_fx, fx2

    phase(f"times (CUDA events, min over reps; {smi})")
    table = []

    def entry(name, count, k_ms, p_ms, m, n1_log, batch, word, shape, record):
        """Print one kernel time beside its bound; with record, add it to the
        kernel table."""
        base = name.rsplit("_", 1)[0]
        b_ms, b_by = bound(*kernel_work(base, m, n1_log, batch, word))
        print(f"  {name} {shape}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.1f} us ({b_by}; {b_ms / k_ms:.0%} of it)", flush=True)
        if record:
            table.append({"name": name, "route": "cuda", "source": SOURCES[base],
                          "replaces": REPLACES[base], "launches": count,
                          "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                          "shape": shape})

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
            entry(name, launches[name], k_ms, p_ms, p.m, p.m, BATCH_HE, plan.word,
                  f"m14 batch {BATCH_HE}", record=True)
        k_ms, p_ms = in_turns(torch, lambda: api.negacyclic_mul(x, y, p),
                              lambda: plain_product(p, x, y), 5, 2)
        print(f"  {case} negacyclic_mul batch {BATCH_HE}: kernels {k_ms * 1e3:.1f} us "
              f"({BATCH_HE / k_ms * 1e3:,.0f} products/s), plain {p_ms * 1e3:.1f} us "
              f"({BATCH_HE / p_ms * 1e3:,.0f} products/s)", flush=True)

    # the m14 q62 forward at batch 1024 through both forms, for 'auto'
    p = params["q62"]
    x = he["q62"][0]
    k_ms, s_ms = in_turns(torch, lambda: api.fwd_ntt(x, p, "pallas-fused"),
                          lambda: api.fwd_ntt(x, p, "sixstep"), 10, 10)
    print(f"  q62 m14 fwd_ntt batch {BATCH_HE}: pallas-fused (K1) {k_ms * 1e3:.1f} us, "
          f"sixstep (K4 + K5) {s_ms * 1e3:.1f} us", flush=True)
    del he, rt

    for size, batch in TWO_PASS:
        p, plan, ops, tabs, n1, word = two_pass_ops(size)
        a = rand(p, batch)
        c = twopass.fwd_cols(a, plan, n1)
        f = twopass.fwd_rows(c, plan, n1)
        r = twopass.inv_rows(f, plan, n1)
        consts = plan.inv_consts
        runs = {
            f"fwd_cols_{word}": (lambda: twopass.fwd_cols(a, plan, n1),
                                 lambda: sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q,
                                                          n1)),
            f"fwd_rows_{word}": (lambda: twopass.fwd_rows(c, plan, n1),
                                 lambda: sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q,
                                                          n1)),
            f"inv_rows_{word}": (lambda: twopass.inv_rows(f, plan, n1),
                                 lambda: sixstep.inv_rows(f, ops, tabs.w_inv,
                                                          tabs.w_inv_con, p.q, n1)),
            f"inv_cols_{word}": (lambda: twopass.inv_cols(r, plan, n1),
                                 lambda: sixstep.inv_cols(r, ops, tabs.w_inv,
                                                          tabs.w_inv_con, *consts, p.q, n1)),
        }
        main_size = size.startswith("m16")
        for name, (kern, plain) in runs.items():
            k_ms, p_ms = in_turns(torch, kern, plain, 10, 2)
            entry(name, launches2[name], k_ms, p_ms, p.m, n1, batch, plan.word,
                  f"{size} batch {batch}", record=main_size)
        if main_size:
            x, y = he2[size]
            k_ms, p_ms = in_turns(torch, lambda: pointwise.mul_mod(x, y, p.q),
                                  lambda: ops.mul_mod(x, y, p.q), 10, 2)
            entry(f"mul_mod_{word}", launches2[f"mul_mod_{word}"], k_ms, p_ms, p.m, n1,
                  batch, plan.word, f"{size} batch {batch}", record=False)
            k_ms, p_ms = in_turns(torch, lambda: api.negacyclic_mul(x, y, p),
                                  lambda: plain_product(p, x, y), 5, 2)
            b_ms = sum(bound(*kernel_work(k, p.m, n1, batch, plan.word))[0] * n
                       for k, n in (("fwd_cols", 2), ("fwd_rows", 2), ("mul_mod", 1),
                                    ("inv_rows", 1), ("inv_cols", 1)))
            print(f"  {size} negacyclic_mul batch {batch}: kernels {k_ms * 1e3:.1f} us "
                  f"({batch / k_ms * 1e3:,.0f} products/s), plain {p_ms * 1e3:.1f} us, "
                  f"sum of the seven launches' bounds {b_ms * 1e3:.1f} us", flush=True)
        del a, c, f, r
        torch.cuda.empty_cache()
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ntt_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")

    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
