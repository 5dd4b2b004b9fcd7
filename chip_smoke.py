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
4. K1 / K2 at every size they serve: at both widths and every m from 1 to
   fused.max_logn(word) (14 at word 64, 15 at word 32), batch 3, and at
   m = 14 batch 500 (more than one wave of blocks), K1 strict and lazy on
   inputs below 4q and K2 equal to their plain versions, bit for bit; K2
   with a final-stage constant one bit wider than the word at m = 3 (N
   below the 16 words a thread holds) and m = 14;
5. main path within one block: with every launch count set to 0, the HE
   batch of 1024 polynomials through api.negacyclic_mul, a batch-128
   round trip inv_ntt(fwd_ntt(a)) == a at both widths, and the reference
   fixtures 0 to 14 (m 8-15) through 'auto'; the products must equal the
   plain path's and, at sampled coefficients, the schoolbook negacyclic
   convolution, the fixtures' forwards the plain path's and the NTT by
   definition at sampled outputs; K1, K2 and K3 must have been launched;
6. two-pass kernels vs plain: K4 (fwd_cols), K5 (fwd_rows, strict and
   lazy, both output layouts), K6 (inv_rows, both input layouts) and K7
   (inv_cols, also with a final-stage constant one bit wider than the
   word) against their plain versions, bit for bit, at N = 2^16 batch 128
   and N = 2^20 batch 16 at both widths and N = 2^24 batch 1 at 62 bits;
   at N = 2^16 two rows of the forward against the NTT by its definition;
7. K4-K7 at every m they serve in the API: at both widths and every m
   from 1 to 24 at the API's split (the 'sixstep' variant takes any m; its
   split gives N1 = 2 up to m = 8 and N2 = 1 at m = 1, so every
   instantiation of 2, 4, 8 and 16 words a thread runs), batch 3 (1 from
   m = 21, where the plain versions take most of the time), and at m = 16
   batch 300 (more than one wave of blocks), K4 on inputs below 4q,
   K5 strict and lazy in both output layouts, K6 from both input layouts
   (and equal between them), K7, and K7 with a final-stage constant one
   bit wider than the word equal to their plain versions, bit for bit;
8. main path beyond one block: with every launch count set to 0, the CKKS
   product of 128 residue polynomials at N = 2^16 (both widths), round
   trips at N = 2^20 (batch 16, both widths) and N = 2^24 (batch 1), and
   the reference fixtures 15 to 18 through 'auto'; products equal to the
   plain path's and to the schoolbook product at sampled coefficients,
   round trips exact; K4 to K7 must have been launched at both widths;
9. K8 and 'sixstep-rec' vs plain: at both widths and every m from 2 to
   24, batch 3 (and K8 at m16 batch 128; the two-level transforms batch 1
   from m = 21), K8 (twist_mul) with the forward
   and the inverse twist on inputs below 4q equal to its plain version;
   the two-level forward (K4 at the rec split, K8, K1), strict and lazy,
   and its inverse (K2, K8, K7 with the level-1 constants) equal to the
   plain compositions (``rec.plain_fwd`` / ``plain_inv``), the strict
   forward equal to the flat 'sixstep', the round trip exact;
10. the rec slice's main path: with every launch count set to 0,
   ``fwd_ntt`` / ``inv_ntt`` through 'sixstep-rec' at m24 (word 64, 128 MB)
   and m23 (word 32), batch 1, and through 'auto' at the first cell of
   ``api.REC_CELLS`` (word 32, m17, batch 128), ``api.DeviceNtt.negacyclic``
   at m14 q62 batch 1024 (strict and lazy handle) and a
   ``rns.DeviceRnsTower`` of three 30-bit primes at m14 batch 1024, and the
   tower's big-int product at batch 1; round trips exact, forwards equal
   to the flat 'sixstep', the handles' products equal to
   ``api.negacyclic_mul`` and to the schoolbook product at sampled
   coefficients, the tower's equal to the host tower's and its big-int
   product to the schoolbook one over Python ints; K1-K4, K7 and K8 must
   have been launched at both widths;
11. lab kernels vs plain: at N = 2^14, batch 32, n1_log 7 (and 4), both
   widths, inputs below 4q: L1 (fwd_fused_v2, two-stage and one-stage
   rounds, strict and lazy), L2 (fwd_fused_v3, strict, lazy, kept
   transposed) and the four L3 probes against their plain versions, bit
   for bit;
12. the lab path: with every launch count set to 0,
   ``python -m ntt_tpu_torch.lab --cases both --no-time`` (N = 2^14, batch
   512): every forward candidate equal to the plain six-step and to K1's
   output, K2 to the plain inverse, every probe to its plain version; K1
   and every L1 / L2 / L3 kernel must have been launched at both widths;
13. times: warm-up, minimum over repetitions, kernel and plain version in
   turns, beside the card's name and power limit; each kernel's bound, the
   larger of its bytes over the memory rate and its integer multiplies
   over the multiply rate.  Every kernel is timed as the lab times it (a
   CUDA graph of launches between two CUDA events, so the host's launch
   overhead stays out); the plain versions and the API calls between two
   CUDA events around one call.  K1 / K2 at every m from 10 to
   max_logn(word), and K4-K7 at every m from 15 (word 64) / 16 (word 32)
   to 24, at 2^24 words a call, beside their bounds; K4-K7 at the sizes of
   phase 6, K5 and K6 also in the transposed layout that the product keeps
   between them; K8 at the round trips' shapes; 'sixstep-rec' against the
   flat 'sixstep', forward and inverse, at every m from 16 to 24 at batch 1
   and 8, at m16-m20 batch 128 and at m17 batch 32-512, both widths (one
   API call's device time from a CUDA graph and its time in a stream of
   back-to-back calls, flat, rec, rec, flat), and the cells where rec wins
   both ways in both views beside ``api.REC_CELLS``; the handle's and the tower's
   products; the lab kernels and K1 at the lab's shape, the lab
   kernels' plain versions at batch 32, and diag_copy's and diag_moves's
   one-call PyTorch equivalents (``clone``, ``flip``) as the lab kernels
   are timed.

Every phase line is followed by the wall clock the phase took, and the
times phase ends with the wall clock of every phase.
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
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BATCH_CHECK = 128
BATCH_HE = 1024
CASES = ("q62", "q29")  # bench_params(14, 62) and FIXTURES[9] (q = 0x1FFC8001)
# two-pass sizes: (name, batch); m16: CKKS at N = 2^16, 128 residues;
# m20 / m24: the single-GPU sizes of BASELINE.json configs[4]
TWO_PASS = (("m16-q62", 128), ("m16-q29", 128), ("m20-q62", 16), ("m20-q29", 16),
            ("m24-q62", 1))
FIXTURES_WITHIN = tuple(range(15))  # m 8-15: 'auto' is pallas-fused (K1 / K2)
FIXTURES_BEYOND = (15, 16, 17, 18)
BATCH_EVERY_M = 3  # K1 / K2 at every m: a small odd batch
LARGE_M = 21  # from here the every-m sweeps of the plain six-step run batch 1

BATCH_WAVES = 500  # and at m14 more polynomials than one wave of blocks
WORDS_PER_M = 1 << 24  # K1 / K2 timed at m 10-14 (15), K4-K7 at m 15 (16)-24, at
# this many words a call
TWO_PASS_FIRST_M = {64: 15, 32: 16}  # K4-K7 timed at every m from the first beyond K1
TWO_PASS_LAST_M = 24
BATCH_TWO_PASS_WAVES = 300  # K4-K7 at m16: more polynomials than one wave of blocks
REC_FIRST_M, REC_LAST_M = 2, 24  # K8 and 'sixstep-rec' held against plain at every m
BATCH_REC_WAVES = 128  # K8 also at m16: more words than one wave of blocks
REC_ROUND_TRIPS = ((64, 24), (32, 23))  # (word, m) of the rec path's round trips, batch 1
REC_TIMED_M = range(16, 25)  # rec against flat at batch 1 and 8, and 128 up to m20
REC_TIMED_BATCH128_LAST_M = 20
REC_TIMED_M17_BATCHES = (1, 8, 32, 64, 128, 256, 512)  # where K4's tiles are slowest
TOWER_BITS = (30, 30, 30)  # the three-prime RNS tower of BASELINE.json configs[2]
CSRC = "ntt_tpu_torch/csrc/"
LAB = "tools/pallas_lab.py:"
LAB_TRANSFORMS = ("fwd_fused_v2_r2", "fwd_fused_v2_r4", "fwd_fused_v3")
PROBES = ("diag_copy", "diag_mul", "diag_math", "diag_moves")
LAB_BATCH_CHECK = 32
SOURCES = {"fwd_fused": CSRC + "ntt_fused.cu", "inv_fused": CSRC + "ntt_fused.cu",
           "mul_mod": CSRC + "pointwise.cu", "fwd_cols": CSRC + "ntt_sixstep.cu",
           "fwd_rows": CSRC + "ntt_sixstep.cu", "inv_rows": CSRC + "ntt_sixstep.cu",
           "inv_cols": CSRC + "ntt_sixstep.cu", "twist_mul": CSRC + "twist.cu",
           **{k: CSRC + "ntt_lab.cu" for k in LAB_TRANSFORMS},
           **{k: CSRC + "probes.cu" for k in PROBES}}
REPLACES = {"fwd_fused": "ntt_tpu/kernels/pallas_fused.py:230",
            "inv_fused": "ntt_tpu/kernels/pallas_fused.py:257",
            "mul_mod": "ntt_tpu/api.py:1517",
            "fwd_cols": "ntt_tpu/kernels/sixstep.py:259",
            "fwd_rows": "ntt_tpu/kernels/sixstep.py:294",
            "inv_rows": "ntt_tpu/kernels/pallas_fused.py:286",
            "inv_cols": "ntt_tpu/kernels/pallas_fused.py:307",
            "twist_mul": "ntt_tpu/kernels/sixstep.py:465",
            "fwd_fused_v2_r2": LAB + "127", "fwd_fused_v2_r4": LAB + "127",
            "fwd_fused_v3": LAB + "326", "diag_copy": LAB + "444", "diag_mul": LAB + "402",
            "diag_math": LAB + "455", "diag_moves": LAB + "479"}
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
N_MULTS = 42  # the multiplies of diag_mul on each 32-bit half (probes.N_MULTS)


def every_m_batch(m: int) -> int:
    """The sweeps' batch at m: BATCH_EVERY_M, 1 from LARGE_M up (the plain
    versions they are held against take most of the script's time there)."""
    return 1 if m >= LARGE_M else BATCH_EVERY_M


def kernel_work(kernel: str, m: int, n1_log: int, batch: int, word: int):
    """(bytes, 32-bit multiplies) one launch must move and do: each input
    read once (the twiddle entries it uses included), each output written
    once.  The lab's transforms do K1's work; diag_math runs m rounds of
    butterflies on N/2 pairs, as the lab calls it; twist_mul (n1_log the
    rec split) reads its four tables, (N1, HI) and (N1, LO) words, once
    and does two Shoup products a word."""
    n, size = 1 << m, word // 8
    data = 2 * batch * n * size
    bfly = batch * n // 2 * SHOUP_MULS[word]  # one stage
    n1 = 1 << n1_log
    twist_lo = 1 << (m - n1_log + 1) // 2
    twist_hi = (n >> n1_log) // twist_lo
    fused = (data + 2 * n * size, bfly * m)
    return {
        "fwd_fused": fused,
        **{k: fused for k in LAB_TRANSFORMS},
        "diag_copy": (data, 0),
        "diag_moves": (data, 0),
        "diag_mul": (data, batch * n * N_MULTS * word // 32),
        "diag_math": (data + 2 * size, bfly * m),
        "inv_fused": (data + 2 * n * size, bfly * (m + 1)),  # final stage: two
        "mul_mod": (3 * batch * n * size, batch * n * MUL_MOD_MULS[word]),
        "fwd_cols": (data + 2 * n1 * size, bfly * n1_log),
        "inv_cols": (data + 2 * n1 * size, bfly * (n1_log + 1)),
        "fwd_rows": (data + 2 * (n - n1) * size, bfly * (m - n1_log)),
        "inv_rows": (data + 2 * (n - n1) * size, bfly * (m - n1_log)),
        "twist_mul": (data + 2 * n1 * (twist_hi + twist_lo) * size,
                      2 * batch * n * SHOUP_MULS[word]),
    }[kernel]


def bound(nbytes: int, muls: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, muls / INT_MULS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class PhaseClock:
    """The script's phases and the host clock at the start of each."""

    def __init__(self):
        self.starts: list[tuple[str, float]] = []

    def phase(self, name: str) -> None:
        """Start a phase: print the wall clock the previous one took."""
        now = time.perf_counter()
        if self.starts:
            print(f"  ({now - self.starts[-1][1]:.1f} s wall clock)", flush=True)
        self.starts.append((name, now))
        print(f"== {name}", flush=True)

    def seconds(self) -> dict[str, float]:
        """Seconds of wall clock each phase took, up to now."""
        ends = [t for _, t in self.starts[1:]] + [time.perf_counter()]
        return {name: round(end - start, 1) for (name, start), end in zip(self.starts, ends)}


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


def kernel_in_turns(torch, lab, kernel, plain, reps_p: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain: the
    kernel's device time from a CUDA graph of launches (lab.cuda_us; one
    call between two events would also time the host's enqueue, as long as
    a short kernel), the plain version's between two CUDA events."""
    p1 = cuda_ms(torch, plain, reps_p)
    k_ms = min(lab.cuda_us(lambda _: kernel(), None, 3, lab.INNER) for _ in range(2)) / 1e3
    return k_ms, min(p1, cuda_ms(torch, plain, reps_p))


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

    clock = PhaseClock()
    phase = clock.phase
    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (ROOT / "ntt_tpu_torch" / "csrc").is_dir():
        print(f"ntt_tpu_torch/ not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ntt_tpu_torch import FIXTURES, NttParams, api, bench_params, lab, native, rns
    from ntt_tpu_torch import modmath as mm
    from ntt_tpu_torch.kernels import fused, fused_lab, pointwise, probes, rec, sixstep, twopass
    from ntt_tpu_torch.kernels.elems import pick_ops
    from ntt_tpu_torch.plan import get_plan

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = lab.card(dev)
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand_dev(p, batch, lazy=False):
        """Values below q (with lazy, below 4q: plus 0-3 q, wrapping as the
        unsigned words do), drawn on the card: no host copy of large inputs."""
        shape, dtype = (batch, p.n), mm.dtype_for(p.q)
        x = torch.randint(0, p.q, shape, generator=gen, device=dev, dtype=dtype)
        if lazy:
            x += torch.randint(0, 4, shape, generator=gen, device=dev, dtype=dtype) * mm.s64(p.q)
        return x

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

    def note(name, got, want, what, quiet=False):
        if not torch.equal(got, want):
            err = max_abs_err(np, mm.to_host(got), mm.to_host(want))
            raise AssertionError(f"{what}: kernel differs from the plain version "
                                 f"(max abs err {err})")
        errs[name] = errs.get(name, 0)  # equal: no error
        if not quiet:
            print(f"  {what}: equal to plain ({tuple(got.shape)})", flush=True)

    def check_fixtures(inputs, fwd, back):
        """Reference fixtures through 'auto': the forward equal to the plain
        path and, at sampled outputs of two rows, to the NTT by definition;
        the round trip exact."""
        for i, a in inputs.items():
            p = FIXTURES[i]
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            if not torch.equal(fwd[i], sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q)):
                raise AssertionError(f"fixture {i}: fwd_ntt differs from the plain path")
            if not torch.equal(back[i], a):
                raise AssertionError(f"fixture {i}: inv_ntt(fwd_ntt(a)) != a")
            js = check_ntt_rows(p, a, fwd[i], fwd[i], f"fixture {i}")
            print(f"  fixture {i} (m {p.m}, q {p.q:#x}): fwd_ntt equals the plain path and, "
                  f"at outputs {js} of two rows, the NTT by definition; round trip exact",
                  flush=True)

    def wide_inv(p, plan, f):
        """K2 launched directly with a lazy final-stage constant in [q, 2q),
        whose Shoup constant is one bit wider than the word (no params give
        one: tmp = n_inv * w_inv[1] lands below q), and its plain version."""
        ops, tabs, inv_c = pick_ops(p.q), plan.device_tables(dev), plan.inv_consts
        tmp_w = p.q + p.q // 3
        con_w = (tmp_w << plan.word) // p.q
        out = torch.empty_like(f)
        native.launch(f"inv_fused_u{plan.word}", f.data_ptr(), out.data_ptr(),
                      tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), p.q, inv_c[0],
                      inv_c[1], tmp_w, con_w & ((1 << plan.word) - 1), con_w >> plan.word,
                      f.shape[0], p.m, native.stream(dev))
        return out, sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con, inv_c[0],
                                        inv_c[1], tmp_w, con_w, p.q)

    def wide_inv_cols(p, plan, r, n1):
        """K7 launched directly with the same wide final-stage constant, at
        the tile its wrapper takes, and its plain version."""
        ops, tabs = pick_ops(p.q), plan.device_tables(dev)
        n_inv, n_inv_con = plan.inv_consts[:2]
        tmp_w = p.q + p.q // 3
        con_w = (tmp_w << plan.word) // p.q
        out = torch.empty_like(r)
        tc = twopass.round_tile_log(n1, p.m - n1, plan.word, rows=False)
        native.launch(f"inv_cols_u{plan.word}", r.data_ptr(), out.data_ptr(),
                      tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), p.q, n_inv,
                      n_inv_con, tmp_w, con_w & ((1 << plan.word) - 1), con_w >> plan.word,
                      r.shape[0], n1, p.m - n1, tc, native.stream(dev))
        return out, sixstep.inv_cols(r, ops, tabs.w_inv, tabs.w_inv_con, n_inv, n_inv_con,
                                     tmp_w, con_w, p.q, n1)

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
        note(f"inv_fused_{word}", *wide_inv(p, plan, k1),
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

    def params_at(m, word):
        """The 62-bit bench q at word 64, a 29-bit q at word 32."""
        return bench_params(m, 62) if word == 64 else NttParams.generate(29, m)

    def every_m(word):
        """(m, params) for every m K1 / K2 serve at a width."""
        for m in range(1, fused.max_logn(word) + 1):
            yield m, params_at(m, word)

    def two_pass_m(word, first=None):
        """(m, params, n1_log) for every m of the K4 / K5 sweep at a width
        (from ``first``), at the API's split."""
        for m in range(first or TWO_PASS_FIRST_M[word], TWO_PASS_LAST_M + 1):
            yield m, params_at(m, word), sixstep.word_split(1 << m, word)

    phase(f"K1 / K2 vs plain at every m they serve (batch {BATCH_EVERY_M}), and at m14 "
          f"batch {BATCH_WAVES}")
    for word in (64, 32):
        done = []
        for m, p in every_m(word):
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            for batch in (BATCH_EVERY_M, BATCH_WAVES) if m == 14 else (BATCH_EVERY_M,):
                a = rand(p, batch, hi=4 * p.q)
                tag = f"w{word} m{m} b{batch}"
                for strict in (True, False):
                    note(f"fwd_fused_u{word}", fused.fwd_fused(a, plan, strict),
                         sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q, strict=strict),
                         f"{tag} K1 {'strict' if strict else 'lazy'}, input < 4q", quiet=True)
                f = sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q)
                k2 = fused.inv_fused(f, plan)
                note(f"inv_fused_u{word}", k2,
                     sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts,
                                         p.q), f"{tag} K2", quiet=True)
                if m in (3, 14):
                    note(f"inv_fused_u{word}", *wide_inv(p, plan, f),
                         f"{tag} K2 with a {word + 1}-bit final constant", quiet=True)
                done.append(tag)
                del a, f, k2
        print(f"  w{word}: K1 (strict, lazy, inputs < 4q) and K2 equal to plain at "
              f"{', '.join(done)}; K2 with a {word + 1}-bit final constant at m3 and m14",
              flush=True)

    phase(f"main path: negacyclic_mul at batch {BATCH_HE}, round trip at batch {BATCH_CHECK}, "
          f"fixtures {FIXTURES_WITHIN[0]}-{FIXTURES_WITHIN[-1]} through 'auto'")
    he = {case: (rand(params[case], BATCH_HE), rand(params[case], BATCH_HE)) for case in CASES}
    rt = {case: rand(params[case], BATCH_CHECK) for case in CASES}
    fx = {i: rand(FIXTURES[i], 4) for i in FIXTURES_WITHIN}
    torch.cuda.synchronize()
    for counts in (fused.LAUNCHES, pointwise.LAUNCHES):
        for k in counts:
            counts[k] = 0
    prod, back = {}, {}
    for case in CASES:
        p = params[case]
        prod[case] = api.negacyclic_mul(*he[case], p)
        back[case] = api.inv_ntt(api.fwd_ntt(rt[case], p), p)
    fwd_fx = {i: api.fwd_ntt(a, FIXTURES[i]) for i, a in fx.items()}
    back_fx = {i: api.inv_ntt(f, FIXTURES[i]) for i, f in fwd_fx.items()}
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
    check_fixtures(fx, fwd_fx, back_fx)
    del fx, fwd_fx, back_fx

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
        note(f"inv_cols_{word}", k7, sixstep.inv_cols(k6, ops, tabs.w_inv, tabs.w_inv_con,
                                                      *plan.inv_consts, p.q, n1),
             f"{tag} K7 inv_cols")
        if not torch.equal(k7, a):
            raise AssertionError(f"{tag}: K7(K6(K5(K4(a)))) != a")
        # K7's branch for a final-stage constant one bit wider than the word,
        # driven directly as K2's is above
        note(f"inv_cols_{word}", *wide_inv_cols(p, plan, k6, n1),
             f"{tag} K7 inv_cols with a {plan.word + 1}-bit final constant")
        if p.m <= 17:
            js = check_ntt_rows(p, a, k5[True, False], k5[False, False], tag)
            print(f"  {tag}: two rows of K4 + K5 (strict, lazy mod q) at outputs {js} match "
                  "the NTT by definition", flush=True)
        del a, k4, k5, k6, k6t, k7
        torch.cuda.empty_cache()

    phase(f"K4-K7 vs plain at every m from 1 to {TWO_PASS_LAST_M} (batch {BATCH_EVERY_M}, 1 "
          f"from m{LARGE_M}), "
          f"and at m16 batch {BATCH_TWO_PASS_WAVES}")
    for word in (64, 32):
        done = []
        for m, p, n1 in two_pass_m(word, first=1):
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            for batch in (BATCH_EVERY_M, BATCH_TWO_PASS_WAVES) if m == 16 else (every_m_batch(m),):
                tag = f"w{word} m{m} b{batch} (n1_log {n1})"
                a = rand(p, batch, hi=4 * p.q)
                c = sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q, n1)
                note(f"fwd_cols_u{word}", twopass.fwd_cols(a, plan, n1), c,
                     f"{tag} K4 on input < 4q", quiet=True)
                f = {}
                for strict in (True, False):
                    for keep_t in (False, True):
                        f[strict, keep_t] = sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q, n1,
                                                             strict, keep_t)
                        note(f"fwd_rows_u{word}", twopass.fwd_rows(c, plan, n1, strict, keep_t),
                             f[strict, keep_t], f"{tag} K5 {'strict' if strict else 'lazy'}"
                             f"{', kept transposed' if keep_t else ''}", quiet=True)
                r = sixstep.inv_rows(f[True, False], ops, tabs.w_inv, tabs.w_inv_con, p.q, n1)
                k6 = twopass.inv_rows(f[True, False], plan, n1)
                note(f"inv_rows_u{word}", k6, r, f"{tag} K6", quiet=True)
                k6t = twopass.inv_rows(f[True, True], plan, n1, input_transposed=True)
                note(f"inv_rows_u{word}", k6t,
                     sixstep.inv_rows(f[True, True], ops, tabs.w_inv, tabs.w_inv_con, p.q, n1,
                                      True), f"{tag} K6 from the transposed layout", quiet=True)
                if not torch.equal(k6, k6t):
                    raise AssertionError(f"{tag}: K6 differs between the two input layouts")
                note(f"inv_cols_u{word}", twopass.inv_cols(r, plan, n1),
                     sixstep.inv_cols(r, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts,
                                      p.q, n1), f"{tag} K7", quiet=True)
                note(f"inv_cols_u{word}", *wide_inv_cols(p, plan, r, n1),
                     f"{tag} K7 with a {word + 1}-bit final constant", quiet=True)
                done.append(f"m{m} b{batch}")
                del a, c, f, r, k6, k6t
            torch.cuda.empty_cache()
        print(f"  w{word}: K4 (input < 4q), K5 (strict, lazy, both layouts), K6 (both "
              f"layouts), K7 and K7 with a {word + 1}-bit final constant equal to plain at "
              f"{', '.join(done)}", flush=True)

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
    check_fixtures(fx2, fwd2, back_fx)
    del prod2, back2, fwd2, back_fx, fx2

    phase(f"K8 and sixstep-rec vs plain at every m from {REC_FIRST_M} to {REC_LAST_M} (K8 batch "
          f"{BATCH_EVERY_M} and at m16 batch {BATCH_REC_WAVES}; sixstep-rec batch {BATCH_EVERY_M}, "
          f"1 from m{LARGE_M})")
    for word in (64, 32):
        done = []
        for m in range(REC_FIRST_M, REC_LAST_M + 1):
            p = params_at(m, word)
            plan, ops = get_plan(p), pick_ops(p.q)
            l1 = sixstep.rec_split(m)
            for batch in (BATCH_EVERY_M, BATCH_REC_WAVES) if m == 16 else (BATCH_EVERY_M,):
                tag = f"w{word} m{m} b{batch} (n1_log {l1})"
                lazy_in = rand_dev(p, batch, lazy=True)
                for inverse in (False, True):
                    tw = plan.device_tables(dev).twist(l1, inverse)
                    note(f"twist_mul_u{word}", rec.twist_mul(lazy_in, plan, l1, inverse),
                         sixstep.twist_mul(lazy_in, ops, tw, p.q),
                         f"{tag} K8 {'inverse' if inverse else 'forward'} on input < 4q",
                         quiet=True)
                del lazy_in
                done.append(f"m{m} b{batch}")
            x = rand_dev(p, every_m_batch(m))
            f = {}
            for strict in (True, False):
                f[strict] = api.fwd_ntt(x, p, "sixstep-rec", lazy=not strict)
                note("sixstep-rec", f[strict], rec.plain_fwd(x, plan, strict),
                     f"w{word} m{m} sixstep-rec {'strict' if strict else 'lazy'}", quiet=True)
            if not torch.equal(f[True], api.fwd_ntt(x, p, "sixstep")):
                raise AssertionError(f"w{word} m{m}: sixstep-rec differs from the flat sixstep")
            back = api.inv_ntt(f[True], p, "sixstep-rec")
            note("sixstep-rec", back, rec.plain_inv(f[True], plan),
                 f"w{word} m{m} sixstep-rec inverse", quiet=True)
            if not torch.equal(back, x):
                raise AssertionError(f"w{word} m{m}: sixstep-rec round trip differs")
            del x, f, back
        torch.cuda.empty_cache()
        print(f"  w{word}: K8 (both twists, input < 4q) equal to plain at {', '.join(done)}; "
              f"sixstep-rec (strict, lazy, inverse; K4 / K7 at the rec split) equal to plain, "
              f"strict equal to the flat sixstep, round trip exact at every m from "
              f"{REC_FIRST_M} to {REC_LAST_M}", flush=True)

    phase("main path of the rec slice: fwd_ntt / inv_ntt through 'sixstep-rec' at "
          + ", ".join(f"w{w} m{m}" for w, m in REC_ROUND_TRIPS)
          + " batch 1 and through 'auto' at the first cell of api.REC_CELLS"
          + f", DeviceNtt.negacyclic q62 m14 batch {BATCH_HE}, DeviceRnsTower "
          f"{TOWER_BITS} m14 batch {BATCH_HE} and its big-int product at batch 1")
    rt3 = {(w, m): (params_at(m, w), rand(params_at(m, w), 1)) for w, m in REC_ROUND_TRIPS}
    (auto_w, auto_m), (auto_rows, _) = next(iter(api.REC_CELLS.items()))
    auto_p = params_at(auto_m, auto_w)
    auto_x = rand_dev(auto_p, auto_rows)
    p14 = params["q62"]
    ctx = api.DeviceNtt(p14, device=dev)
    hx = rng.integers(0, p14.q, size=(2, BATCH_HE, p14.n), dtype=np.uint64)
    hx_dev = (ctx.from_host(hx[0]), ctx.from_host(hx[1]))
    tower = rns.DeviceRnsTower(14, TOWER_BITS, device=dev)
    big_q = tower.modulus_product
    tx = [tower.encode(rng.integers(0, 1 << 62, size=(BATCH_HE, tower.n), dtype=np.uint64))
          for _ in range(2)]
    big = [np.array([int(v) % big_q for v in rng.integers(0, 1 << 40, size=tower.n,
                                                          dtype=np.uint64)], dtype=object)
           for _ in range(2)]
    tx_dev = (tower.from_host(tx[0]), tower.from_host(tx[1]))
    torch.cuda.synchronize()
    rec_counts = (fused.LAUNCHES, pointwise.LAUNCHES, twopass.LAUNCHES, rec.LAUNCHES)
    for counts in rec_counts:
        for k in counts:
            counts[k] = 0
    fwd3 = {k: api.fwd_ntt(x, p, "sixstep-rec") for k, (p, x) in rt3.items()}
    back3 = {k: api.inv_ntt(fwd3[k], rt3[k][0], "sixstep-rec") for k in rt3}
    fwd_auto = api.fwd_ntt(auto_x, auto_p)
    back_auto = api.inv_ntt(fwd_auto, auto_p)
    hprod = ctx.negacyclic(*hx_dev)
    hprod_lazy = api.DeviceNtt(p14, lazy=True, device=dev).negacyclic(*hx_dev)
    tprod = tower.negacyclic(*tx_dev)
    tbig = tower.negacyclic_mul_bigint(*big)
    torch.cuda.synchronize()
    launches4 = {k: v for c in rec_counts for k, v in c.items()}
    print(f"  launch counts of this path: {launches4}", flush=True)
    needed = [f"{k}_u{w}" for k in ("twist_mul", "fwd_cols", "inv_cols", "fwd_fused",
                                    "inv_fused", "mul_mod") for w in (64, 32)]
    idle = [k for k in needed if launches4[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the rec slice's path: {idle}")
    for (w, m), (p, x) in rt3.items():
        if not torch.equal(back3[w, m], x):
            raise AssertionError(f"w{w} m{m}: inv_rec(fwd_rec(a)) != a")
        if not torch.equal(fwd3[w, m], api.fwd_ntt(x, p, "sixstep")):
            raise AssertionError(f"w{w} m{m}: sixstep-rec differs from the flat sixstep")
        print(f"  w{w} m{m} q {p.q:#x}: fwd_ntt through sixstep-rec equals the flat sixstep, "
              "inv_ntt(fwd_ntt(a)) == a", flush=True)
    auto_v = api._pick(get_plan(auto_p), "auto", rows=auto_rows).name
    if auto_v != "sixstep-rec" or not torch.equal(back_auto, auto_x) or not torch.equal(
            fwd_auto, api.fwd_ntt(auto_x, auto_p, "sixstep")):
        raise AssertionError(f"w{auto_w} m{auto_m} batch {auto_rows} through 'auto' ({auto_v}): "
                             "forward differs from the flat sixstep or the round trip fails")
    print(f"  w{auto_w} m{auto_m} batch {auto_rows} through 'auto' (a cell of api.REC_CELLS, "
          f"{auto_v}): forward equals the flat sixstep, round trip exact", flush=True)
    if not torch.equal(hprod, api.negacyclic_mul(*hx_dev, p14)):
        raise AssertionError("DeviceNtt.negacyclic differs from api.negacyclic_mul")
    if not torch.equal(hprod_lazy, hprod):
        raise AssertionError("the lazy handle's product (K3 on lazy forwards) differs")
    ks = check_product_rows(p14, *hx_dev, hprod, "DeviceNtt q62 m14")
    print(f"  DeviceNtt q62 m14: negacyclic {tuple(hprod.shape)} (and the lazy handle's) equals "
          f"api.negacyclic_mul and, at coefficients {ks} of two rows, the schoolbook product",
          flush=True)
    host_tower = rns.RnsTower(14, params=tower.params, device=dev)
    if not np.array_equal(tower.to_host(tprod), host_tower.negacyclic_mul(*tx)):
        raise AssertionError("DeviceRnsTower.negacyclic differs from the host tower")
    tks = sorted({0, 1, tower.n - 1, *rng.integers(0, tower.n, 3).tolist()})
    ring = argparse.Namespace(n=tower.n, q=big_q)
    for k in tks:
        if int(tbig[k]) != schoolbook_at(*big, k, ring):
            raise AssertionError(f"tower big-int product coeff {k} differs from the schoolbook")
    print(f"  DeviceRnsTower {[hex(q) for q in tower.moduli]} m14: negacyclic {len(tprod)} x "
          f"{tuple(tprod[0].shape)} equals the host tower; the big-int product "
          f"({big_q.bit_length()}-bit Q) equals the schoolbook at coefficients {tks}", flush=True)
    del fwd3, back3, rt3, tprod, hprod, hprod_lazy, fwd_auto, back_auto, auto_x


    lab_cases = ("u32", "u64")
    lab_params = {c: lab.case_params(c, 14) for c in lab_cases}
    lab_n1 = lab.lab_split(14)
    phase(f"lab kernels vs plain: m14 batch {LAB_BATCH_CHECK}, n1_log {lab_n1} (and 4)")
    for case in lab_cases:
        p = lab_params[case]
        plan = get_plan(p)
        word = f"u{plan.word}"
        a = rand(p, LAB_BATCH_CHECK, hi=4 * p.q)
        for group in (1, 2):
            for strict, keep_t in ((True, False), (False, False), (True, True)):
                what = (f"{'strict' if strict else 'lazy'}"
                        f"{', kept transposed' if keep_t else ''}")
                note(f"fwd_fused_v2_r{2 * group}_{word}",
                     fused_lab.fwd_fused_v2(a, plan, lab_n1, group, strict, keep_t),
                     fused_lab.plain(a, plan, lab_n1, strict, keep_t),
                     f"{case} L1 fwd_fused_v2 group {group} {what}")
        for strict, keep_t in ((True, False), (False, False), (True, True)):
            what = f"{'strict' if strict else 'lazy'}{', kept transposed' if keep_t else ''}"
            note(f"fwd_fused_v3_{word}", fused_lab.fwd_fused_v3(a, plan, lab_n1, strict, keep_t),
                 fused_lab.plain(a, plan, lab_n1, strict, keep_t),
                 f"{case} L2 fwd_fused_v3 {what}")
        note(f"fwd_fused_v2_r4_{word}", fused_lab.fwd_fused_v2(a, plan, 4),
             fused_lab.plain(a, plan, 4), f"{case} L1 fwd_fused_v2 group 2 at n1_log 4")
        note(f"fwd_fused_v3_{word}", fused_lab.fwd_fused_v3(a, plan, 4),
             fused_lab.plain(a, plan, 4), f"{case} L2 fwd_fused_v3 at n1_log 4")
        if not torch.equal(fused_lab.fwd_fused_v3(a, plan, lab_n1), fused.fwd_fused(a, plan)):
            raise AssertionError(f"{case}: L2 differs from K1")
        note(f"diag_copy_{word}", probes.diag_copy(a), a.clone(), f"{case} L3 diag_copy")
        note(f"diag_mul_{word}", probes.diag_mul(a), probes.plain_mul(a), f"{case} L3 diag_mul")
        note(f"diag_math_{word}", probes.diag_math(a, plan, p.m),
             probes.plain_math(a, plan, p.m), f"{case} L3 diag_math, {p.m} rounds")
        note(f"diag_moves_{word}", probes.diag_moves(a), a.flip(-1), f"{case} L3 diag_moves")
        del a

    phase("lab path: python -m ntt_tpu_torch.lab --cases both --no-time (m14 batch 512)")
    torch.cuda.synchronize()
    all_counts = (fused.LAUNCHES, pointwise.LAUNCHES, twopass.LAUNCHES, fused_lab.LAUNCHES,
                  probes.LAUNCHES)
    for counts in all_counts:
        for k in counts:
            counts[k] = 0
    records = lab.main(["--cases", "both", "--no-time"])
    torch.cuda.synchronize()
    launches3 = {**fused_lab.LAUNCHES, **probes.LAUNCHES}
    print(f"  launch counts of the lab path: {launches3}; K1 {fused.LAUNCHES}", flush=True)
    idle = [k for k, v in launches3.items() if v == 0]
    idle += [k for k in ("fwd_fused_u32", "fwd_fused_u64") if fused.LAUNCHES[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the lab path: {idle}")
    if len(records) != 2 * len(lab.CANDIDATES) or not all(r["exact"] for r in records):
        raise AssertionError(f"the lab path did not check every candidate: {records}")
    print(f"  {len(records)} candidates bit-exact (transforms against the plain six-step "
          "and K1, probes against their plain versions)", flush=True)

    phase(f"times (kernels from a CUDA graph of launches, plain versions and API calls "
          f"between CUDA events; min over reps; {smi})")
    table = []

    def entry(name, count, k_ms, p_ms, m, n1_log, batch, word, shape, record,
              library_ms=None, plain_shape=None):
        """Print one kernel time beside its bound; with record, add it to the
        kernel table."""
        base = name.rsplit("_", 1)[0]
        b_ms, b_by = bound(*kernel_work(base, m, n1_log, batch, word))
        lib = "" if library_ms is None else f", library {library_ms * 1e3:.1f} us"
        print(f"  {name} {shape}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us"
              f"{f' ({plain_shape})' if plain_shape else ''}{lib}, bound {b_ms * 1e3:.1f} us "
              f"({b_by}; {b_ms / k_ms:.0%} of it)", flush=True)
        if record:
            row = {"name": name, "route": "cuda", "source": SOURCES[base],
                   "replaces": REPLACES[base], "launches": count, "max_abs_err": errs[name],
                   "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": library_ms, "shape": shape}
            if plain_shape:
                row["plain_shape"] = plain_shape
            table.append(row)

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
            k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
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

    # K1 / K2 at every m from 10 up, 2^24 words a call, beside their bounds;
    # device time from a CUDA graph of launches, as the lab times (a lone
    # call between two events can include the host's enqueue)
    for word in (64, 32):
        for m, p in every_m(word):
            if m < 10:
                continue
            plan = get_plan(p)
            batch = WORDS_PER_M >> m
            a = rand(p, batch)
            f = fused.fwd_fused(a, plan)
            k1_ms = lab.cuda_us(lambda x: fused.fwd_fused(x, plan), a, 3, lab.INNER) / 1e3
            k2_ms = lab.cuda_us(lambda x: fused.inv_fused(x, plan), f, 3, lab.INNER) / 1e3
            b1, _ = bound(*kernel_work("fwd_fused", m, m, batch, word))
            b2, _ = bound(*kernel_work("inv_fused", m, m, batch, word))
            print(f"  w{word} m{m} batch {batch}: K1 {k1_ms * 1e3:.1f} us (bound "
                  f"{b1 * 1e3:.1f}, {b1 / k1_ms:.0%}), K2 {k2_ms * 1e3:.1f} us (bound "
                  f"{b2 * 1e3:.1f}, {b2 / k2_ms:.0%})", flush=True)
            del a, f

    # K4-K7 at every m of the two-pass sweep, 2^24 words a call, beside their
    # bounds; device time from a CUDA graph of launches
    for word in (64, 32):
        for m, p, n1 in two_pass_m(word):
            plan = get_plan(p)
            batch = WORDS_PER_M >> m
            a = rand(p, batch)
            c = twopass.fwd_cols(a, plan, n1)
            f = twopass.fwd_rows(c, plan, n1)
            r = twopass.inv_rows(f, plan, n1)
            parts = []
            for k, name, fn, x in (
                    ("K4", "fwd_cols", lambda x: twopass.fwd_cols(x, plan, n1), a),
                    ("K5", "fwd_rows", lambda x: twopass.fwd_rows(x, plan, n1), c),
                    ("K6", "inv_rows", lambda x: twopass.inv_rows(x, plan, n1), f),
                    ("K7", "inv_cols", lambda x: twopass.inv_cols(x, plan, n1), r)):
                k_ms = lab.cuda_us(fn, x, 3, lab.INNER) / 1e3
                b_ms, _ = bound(*kernel_work(name, m, n1, batch, word))
                parts.append(f"{k} {k_ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f}, "
                             f"{b_ms / k_ms:.0%})")
            print(f"  w{word} m{m} batch {batch} (n1_log {n1}): {', '.join(parts)}", flush=True)
            del a, c, f, r
        torch.cuda.empty_cache()

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
            k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
            entry(name, launches2[name], k_ms, p_ms, p.m, n1, batch, plan.word,
                  f"{size} batch {batch}", record=main_size)
        # the product's K5 and K6 keep the transposed layout between them
        ft = twopass.fwd_rows(c, plan, n1, keep_transposed=True)
        runs = {
            f"fwd_rows_{word}": (
                lambda: twopass.fwd_rows(c, plan, n1, keep_transposed=True),
                lambda: sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q, n1, True, True)),
            f"inv_rows_{word}": (
                lambda: twopass.inv_rows(ft, plan, n1, input_transposed=True),
                lambda: sixstep.inv_rows(ft, ops, tabs.w_inv, tabs.w_inv_con, p.q, n1, True)),
        }
        for name, (kern, plain) in runs.items():
            k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
            entry(name, launches2[name], k_ms, p_ms, p.m, n1, batch, plan.word,
                  f"{size} batch {batch}, the transposed layout", record=False)
        if main_size:
            x, y = he2[size]
            k_ms, p_ms = kernel_in_turns(torch, lab, lambda: pointwise.mul_mod(x, y, p.q),
                                         lambda: ops.mul_mod(x, y, p.q), 2)
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
        del a, c, f, r, ft
        torch.cuda.empty_cache()

    # K8 at the rec path's round-trip shapes from a CUDA graph, beside its
    # bound; its plain version between CUDA events
    for w, m in REC_ROUND_TRIPS:
        p = params_at(m, w)
        plan, ops, l1 = get_plan(p), pick_ops(p.q), sixstep.rec_split(m)
        x = rand_dev(p, 1, lazy=True)
        tw = plan.device_tables(dev).twist(l1, False)
        k_ms, p_ms = kernel_in_turns(torch, lab, lambda: rec.twist_mul(x, plan, l1),
                                     lambda: sixstep.twist_mul(x, ops, tw, p.q), 2)
        entry(f"twist_mul_u{w}", launches4[f"twist_mul_u{w}"], k_ms, p_ms, m, l1, 1, w,
              f"m{m} batch 1", record=True)
        del x

    # 'sixstep-rec' against the flat 'sixstep', forward and inverse, one API
    # call two ways: its device time from a CUDA graph, and its time in a
    # stream of back-to-back calls between two CUDA events, which includes
    # the host's launches (a server's view); each in turns flat, rec, rec,
    # flat, the spread the larger of the two forms' differences between
    # passes.  Inputs are drawn on the card (seeded), as timing needs no
    # host copy of them.
    def stream_us(fn, x, calls=20):
        for _ in range(2):
            fn(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / calls

    def graph_us(graph, inner=5, reps=2):
        """Device time of one call from replays of a graph of `inner` calls."""
        best = float("inf")
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / inner)
        return best

    def captured(fn, x, inner=5):
        """A CUDA graph of `inner` calls, after two warm-up calls."""
        for _ in range(2):
            fn(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn(x)
        graph.replay()
        return graph

    def rec_against_flat(p, x, inverse):
        call = api.inv_ntt if inverse else api.fwd_ntt
        fns = {v: (lambda t, v=v: call(t, p, v)) for v in ("sixstep", "sixstep-rec")}
        graphs = {v: captured(fn, x) for v, fn in fns.items()}
        out = {}
        for how, timer in (("graph", lambda v: graph_us(graphs[v])),
                           ("stream", lambda v: stream_us(fns[v], x))):
            flat1, rec1 = timer("sixstep"), timer("sixstep-rec")
            rec2, flat2 = timer("sixstep-rec"), timer("sixstep")
            spread = max(abs(rec1 - rec2), abs(flat1 - flat2))
            out[how] = {"rec_us": min(rec1, rec2), "flat_us": min(flat1, flat2),
                        "spread_us": spread,
                        "rec_wins": min(flat1, flat2) - min(rec1, rec2) > spread}
        del graphs
        return out

    rec_rows = []
    for w in (64, 32):
        for m in REC_TIMED_M:
            p = params_at(m, w)
            batches = (1, 8, 128) if m <= REC_TIMED_BATCH128_LAST_M else (1, 8)
            for batch in REC_TIMED_M17_BATCHES if m == 17 else batches:
                x = rand_dev(p, batch)
                f = api.fwd_ntt(x, p, "sixstep")
                row = {"word": w, "m": m, "batch": batch}
                for d, arg in (("fwd", x), ("inv", f)):
                    row[d] = rec_against_flat(p, arg, d == "inv")
                rec_rows.append(row)
                print(f"  w{w} m{m} batch {batch}: " + "; ".join(
                    f"{d} {how} rec {t['rec_us']:.1f} / flat {t['flat_us']:.1f} us "
                    f"(spread {t['spread_us']:.1f}{', rec faster' if t['rec_wins'] else ''})"
                    for d in ("fwd", "inv") for how, t in row[d].items()), flush=True)
                del x, f
            torch.cuda.empty_cache()
    print(f"  rec against flat: {json.dumps(rec_rows)}", flush=True)
    wins = [(r["word"], r["m"], r["batch"]) for r in rec_rows
            if all(r[d][how]["rec_wins"] for d in ("fwd", "inv") for how in ("graph", "stream"))]
    print(f"  (word, m, batch) where sixstep-rec is faster both ways, in both views: {wins}; "
          f"api.REC_CELLS {api.REC_CELLS}", flush=True)

    # the serving handle's and the tower's products at batch 1024
    k_ms, a_ms = in_turns(torch, lambda: ctx.negacyclic(*hx_dev),
                          lambda: api.negacyclic_mul(*hx_dev, p14), 5, 5)
    g_ms = lab.cuda_us(lambda _: ctx.negacyclic(*hx_dev), None, 3, 5) / 1e3
    print(f"  DeviceNtt q62 m14 negacyclic batch {BATCH_HE}: {k_ms * 1e3:.1f} us between events "
          f"({BATCH_HE / k_ms * 1e3:,.0f} products/s), {g_ms * 1e3:.1f} us from a CUDA graph; "
          f"api.negacyclic_mul {a_ms * 1e3:.1f} us", flush=True)
    t_ms = cuda_ms(torch, lambda: tower.negacyclic(*tx_dev), 5)
    tg_ms = lab.cuda_us(lambda _: tower.negacyclic(*tx_dev), None, 3, 5) / 1e3
    print(f"  DeviceRnsTower {len(TOWER_BITS)} x 30-bit m14 negacyclic batch {BATCH_HE}: "
          f"{t_ms * 1e3:.1f} us between events ({BATCH_HE / t_ms * 1e3:,.0f} ciphertext "
          f"products/s), {tg_ms * 1e3:.1f} us from a CUDA graph", flush=True)
    del hx_dev, tx_dev
    torch.cuda.empty_cache()


    # the lab's kernels at the lab's shape, timed as the lab times them (a
    # CUDA graph of launches); their plain versions at batch 32; the one
    # PyTorch call that computes a probe's function, where there is one
    lab_batch = 512
    library = {"diag_copy": lambda v: v.clone(), "diag_moves": lambda v: v.flip(-1)}
    for case in lab_cases:
        p = lab_params[case]
        plan = get_plan(p)
        word = f"u{plan.word}"
        x = rand(p, lab_batch)
        small = x[:LAB_BATCH_CHECK].contiguous()
        cands = lab.candidates(plan, lab_n1)
        k1_ms = lab.cuda_us(cands["v1"].fn, x, 5, lab.INNER) / 1e3
        parts = {}
        for cand_name, cand in cands.items():
            if cand_name in ("v1", "i1"):
                continue
            # plain, kernel, kernel, plain
            p1 = cuda_ms(torch, lambda: cand.plain(small), 2)
            k_ms = min(lab.cuda_us(cand.fn, x, 5, lab.INNER) for _ in range(2)) / 1e3
            p_ms = min(p1, cuda_ms(torch, lambda: cand.plain(small), 2))
            lib = library.get(cand.kernel)
            lib_ms = None if lib is None else lab.cuda_us(lib, x, 5, lab.INNER) / 1e3
            entry(f"{cand.kernel}_{word}", launches3[f"{cand.kernel}_{word}"], k_ms, p_ms,
                  p.m, lab_n1, lab_batch, plan.word, f"m14 batch {lab_batch}", record=True,
                  library_ms=lib_ms, plain_shape=f"m14 batch {LAB_BATCH_CHECK}")
            parts[cand_name] = k_ms
        print(f"  {case} m14 batch {lab_batch}: K1 {k1_ms * 1e3:.1f} us against "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in parts.items()), flush=True)
        del x, small
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ntt_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")
    print(f"  wall clock a phase, s: {json.dumps(clock.seconds())}", flush=True)

    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
