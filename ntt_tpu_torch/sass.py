"""Count the SASS instructions of one butterfly of ``csrc/modarith.cuh``.

    python -m ntt_tpu_torch.sass

Compiles a small source of one-butterfly kernels for ``sm_90a`` with the
package's nvcc flags (``native.ARCH_FLAGS``), disassembles it with
``cuobjdump -sass`` and prints, for each butterfly and width, the
arithmetic instructions of a kernel that loads a pair, runs one butterfly
(constants as kernel parameters) and stores the pair, less those of the
same kernel that stores the pair swapped instead.  Loads, stores, constant
and special-register reads, branches, EXIT and NOP are not counted.  Needs
nvcc and cuobjdump (the CUDA toolkit), not a card.
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
  extern "C" __global__ void NAME(T* p, T w, T w_con, T q, FinalConsts<T> f) {     \
    T x = p[threadIdx.x], y = p[threadIdx.x + 32];                                 \
    BODY;                                                                          \
    p[threadIdx.x] = x;                                                            \
    p[threadIdx.x + 32] = y;                                                       \
  }
#define WIDTH(T, W)                                                                \
  PAIR(T, none_u##W, { T z = x; x = y; y = z; })                                   \
  PAIR(T, fwd_bfly_u##W, fwd_bfly<T>(x, y, w, w_con, q))                           \
  PAIR(T, bkw_bfly_u##W, bkw_bfly<T>(x, y, w, w_con, q))                           \
  PAIR(T, bkw_final_u##W, bkw_final<T>(x, y, f, q))
WIDTH(u32, 32)
WIDTH(u64, 64)
"""

_NOT_COUNTED = ("LD", "ST", "ULD", "S2R", "S2UR", "BRA", "EXIT", "NOP")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?\w+\s+)?([A-Z][A-Z0-9_.]*)")


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
        if fn and m and not m.group(2).startswith(_NOT_COUNTED):
            out[fn][m.group(2)] += 1
    return out


def butterfly_counts() -> dict[str, dict]:
    """{'fwd_bfly_u64': {'instructions': n, 'opcodes': {...}}, ...}."""
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
        for b in BUTTERFLIES:
            c = funcs[f"{b}_u{w}"]
            diff = {k: v - base.get(k, 0) for k, v in c.items() if v != base.get(k, 0)}
            result[f"{b}_u{w}"] = {"instructions": sum(c.values()) - sum(base.values()),
                                   "opcodes": dict(sorted(diff.items()))}
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    result = butterfly_counts()
    for name, r in result.items():
        print(f"  {name}: {r['instructions']} SASS instructions ({r['opcodes']})")
    print(json.dumps({"sass_per_butterfly": {k: v["instructions"] for k, v in result.items()}}))
    return result


if __name__ == "__main__":
    main()
