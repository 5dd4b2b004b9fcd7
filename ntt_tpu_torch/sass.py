"""Count the SASS instructions of one butterfly of ``csrc/modarith.cuh``.

    python -m ntt_tpu_torch.sass

Compiles a small source of one-butterfly kernels for ``sm_90a`` with the
package's nvcc flags (``native.ARCH_FLAGS``), disassembles it with
``cuobjdump -sass`` and prints, for each butterfly and width, the
arithmetic instructions of a kernel that loads a pair, runs one butterfly
(constants as kernel parameters) and stores the pair, less those of the
same kernel that stores the pair swapped instead.  Loads, stores, constant
and special-register reads, branches, EXIT and NOP are not counted.  Each
butterfly is counted with both reduction policies of the single product,
Shoup (``fwd_bfly_u64``) and Solinas (``fwd_bfly_solinas_u64``, the
NTT_MULMOD=solinas switch), and beside its instructions are its integer
multiplies: the IMAD / IMUL instructions that multiply (not the IMAD.MOV,
IMAD.SHL and IMAD.IADD forms, which move, shift and add), one 32-bit
multiply each, IMAD.WIDE (32 x 32 -> 64 bits plus a 64-bit addend) and
IMAD.HI included, so the count is of 32 x 32-bit multiplier passes.

It also compiles ``csrc/probes.cu`` and prints the innermost loop of the
probes ``diag_mul`` and ``diag_math`` at 16 words a thread: ``diag_mul``'s
step loop must hold 16 (word 32) / 32 (word 64) multiplies, one
``mad.lo.u32`` a 32-bit half, and no loop fewer than its group's halves
(no chain folded into fewer multiplies); ``diag_math``'s round loop holds
its 8 butterflies, so its instructions over 8 are a butterfly's in K1's
setting (constants hoisted out of the loop).  Needs nvcc and cuobjdump
(the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import tempfile

from ntt_tpu_torch import native

BUTTERFLIES = ("fwd_bfly", "bkw_bfly", "bkw_final")

_KERNELS = r"""
#include "modarith.cuh"
using namespace ntt;
#define PAIR(T, NAME, BODY)                                                        \
  extern "C" __global__ void NAME(T* p, T w, T w_con, T q, FinalConsts<T> f,       \
                                  SolinasRed s) {                                  \
    T x = p[threadIdx.x], y = p[threadIdx.x + 32];                                 \
    BODY;                                                                          \
    p[threadIdx.x] = x;                                                            \
    p[threadIdx.x + 32] = y;                                                       \
  }
#define WIDTH(T, W)                                                                \
  PAIR(T, none_u##W, { T z = x; x = y; y = z; })                                   \
  PAIR(T, fwd_bfly_u##W, fwd_bfly<T>(x, y, w, w_con, q))                           \
  PAIR(T, bkw_bfly_u##W, bkw_bfly<T>(x, y, w, w_con, q))                           \
  PAIR(T, bkw_final_u##W, bkw_final<T>(x, y, f, q))                               \
  PAIR(T, fwd_bfly_solinas_u##W, fwd_bfly<T>(x, y, w, w_con, q, s))               \
  PAIR(T, bkw_bfly_solinas_u##W, bkw_bfly<T>(x, y, w, w_con, q, s))               \
  PAIR(T, bkw_final_solinas_u##W, bkw_final<T>(x, y, f, q, s))
WIDTH(u32, 32)
WIDTH(u64, 64)
"""

_NOT_COUNTED = ("LD", "ST", "ULD", "S2R", "S2UR", "BRA", "EXIT", "NOP")
_NOT_MULTIPLIES = ("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?\w+\s+)?([A-Z][A-Z0-9_.]*)")
_BRANCH = re.compile(r"\bBRA(?:\.[A-Z0-9_]+)*\s+(?:`\()?0x([0-9a-f]+)")
# the probes' kernels at 16 words a thread, by a piece of each mangled name:
# the kernel, its word (j: unsigned int, y: unsigned long long) and policy
PROBE_LOOPS = {f"diag_{k}{p}_u{w}": (f"diag_{k}_kernelI{t}Li4E", r)
               for w, t in ((32, "j"), (64, "y")) for k, p, r in
               (("mul", "", ""), ("math", "", "ShoupRed"), ("math", "_solinas", "SolinasRed"))}


def count(sass: str) -> dict[str, collections.Counter]:
    """Opcode counts per function of a ``cuobjdump -sass`` listing, the
    instructions of ``_NOT_COUNTED`` left out."""
    out: dict[str, collections.Counter] = {}
    fn = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = _INSTRUCTION.search(line)
        if fn and m and not m.group(3).startswith(_NOT_COUNTED):
            out[fn][m.group(3)] += 1
    return out


def inner_loops(sass: str) -> dict[str, list[collections.Counter]]:
    """Per function of a ``cuobjdump -sass`` listing, the opcodes of each
    innermost loop, in address order: a loop is a branch back to an earlier
    address, its body the instructions from that address to the branch,
    every instruction counted; innermost, it holds no other such body.  The
    branch that spins on itself after EXIT is no loop."""
    funcs: dict[str, list] = {}
    fn = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = _INSTRUCTION.search(line)
        if fn and m:
            b = _BRANCH.search(line)
            funcs[fn].append((int(m.group(1), 16), m.group(3), int(b.group(1), 16) if b else None))
    out = {}
    for fn, ins in funcs.items():
        loops = [(t, a) for a, _, t in ins if t is not None and t < a]
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in loops)]
        out[fn] = [collections.Counter(op for a, op, _ in ins if lo <= a <= hi)
                   for lo, hi in sorted(inner)]
    return out


def multiplies(opcodes: dict) -> int:
    """The integer multiplies among counted opcodes."""
    return sum(v for k, v in opcodes.items()
               if k.startswith(("IMAD", "IMUL")) and not k.startswith(_NOT_MULTIPLIES))


def butterfly_counts() -> dict[str, dict]:
    """{'fwd_bfly_u64': {'instructions': n, 'multiplies': n, 'opcodes':
    {...}}, ...}, for each butterfly, policy and width."""
    nvcc = native.find_nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    native.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD) as tmp:
        src = pathlib.Path(tmp) / "bfly.cu"
        src.write_text(_KERNELS)
        cubin = src.with_suffix(".cubin")
        subprocess.run([nvcc, *native.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin",
                        "-I", str(native.CSRC), "-o", str(cubin), str(src)],
                       check=True, capture_output=True, text=True, timeout=300)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
    funcs = count(sass)
    result = {}
    for w in (32, 64):
        base = funcs[f"none_u{w}"]
        for b in (f"{b}{p}" for b in BUTTERFLIES for p in ("", "_solinas")):
            c = funcs[f"{b}_u{w}"]
            diff = {k: v - base.get(k, 0) for k, v in c.items() if v != base.get(k, 0)}
            result[f"{b}_u{w}"] = {"instructions": sum(c.values()) - sum(base.values()),
                                   "multiplies": multiplies(diff),
                                   "opcodes": dict(sorted(diff.items()))}
    return result


def probe_loops() -> dict[str, dict]:
    """{'diag_mul_u64': {'instructions': n, 'multiplies': n, 'loops': [...],
    'opcodes': {...}}, ...}: the largest innermost loop of each probe of
    ``PROBE_LOOPS`` in ``csrc/probes.cu`` as the package compiles it, its
    opcodes, and the multiplies of each of its innermost loops (one a size
    of group, 2 to 16 words)."""
    nvcc = native.find_nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    native.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD) as tmp:
        cubin = pathlib.Path(tmp) / "probes.cubin"
        subprocess.run([nvcc, *native.COMPILE_FLAGS, "-cubin", "-o", str(cubin),
                        str(native.CSRC / "probes.cu")],
                       check=True, capture_output=True, text=True, timeout=300)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
    loops = inner_loops(sass)
    result = {}
    for name, (kernel, policy) in PROBE_LOOPS.items():
        fns = [f for f in loops if kernel in f and policy in f]
        if len(fns) != 1:
            raise RuntimeError(f"{name}: {len(fns)} functions match {kernel} {policy}")
        body = max(loops[fns[0]], key=lambda c: sum(c.values()))
        result[name] = {"instructions": sum(body.values()), "multiplies": multiplies(body),
                        "loops": [multiplies(c) for c in loops[fns[0]]],
                        "opcodes": dict(sorted(body.items()))}
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    result = butterfly_counts()
    for name, r in result.items():
        print(f"  {name}: {r['instructions']} SASS instructions, {r['multiplies']} "
              f"multiplies ({r['opcodes']})")
    loops = probe_loops()
    for name, r in loops.items():
        print(f"  {name} at 16 words a thread: innermost loop {r['instructions']} SASS "
              f"instructions, {r['multiplies']} multiplies ({r['opcodes']}); multiplies of "
              f"each innermost loop {r['loops']}")
    print(json.dumps({"sass_per_butterfly": {k: v["instructions"] for k, v in result.items()},
                      "probe_loops": {k: [v["instructions"], v["multiplies"]]
                                      for k, v in loops.items()}}))
    return {**result, **loops}


if __name__ == "__main__":
    main()
