"""K11's design points, changed one part at a time, timed on the card.

    python -m ntt_tpu_torch.k11_lab [--seed SEED]

Builds copies of ``csrc/mxu.cu``, each with one part of the wgmma body
changed, into ``build/k11_lab/`` (nvcc, one process a copy, all started
together), and times each copy's K11 launch (both contracts, scaled, as a
transform's first pass runs it) at m14 batch 1024, m16 batch 128 and m20
batch 16 from a CUDA graph, beside ptxas's registers and spills.  The
copies:

- ``as_is``: the source unchanged (its bits are checked);
- ``two_accumulators``: the diagonals through two int32 tiles, so that one
  diagonal's products run while the last one is shifted or folded (exact;
  its bits are checked);
- ``no_fold``: the three Shoup products replaced by plain adds;
- ``no_staging``: x read and split into the limb planes for the first
  unit only;
- ``no_store``: the finished tile neither reduced nor written;
- ``no_products``: no wgmma issued.

The last four compute wrong bits on purpose: their times say what each
part costs.  Exits 2 without a CUDA card.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ntt_tpu_torch import NttParams, lab, native
from ntt_tpu_torch.kernels import mxu

SHAPES = ((14, 1024, 0xFFF0001), (16, 128, None), (20, 16, None))

_FOLD = ('_Pragma("unroll") for (int e = 0; e < kAcc; ++e) t[e] += '
         'shoup_mul_q2<u32>(s.w[W], s.w_con[W], acc[e], s.q);')
_STAGE = "      stage_x<kLeft>(xb, x, s, row0, c * kChunk, tid / 32, lane);"
_STORE = "    store_tile<kLeft, kScaled>(t, xb, out, s_tab, s_con, s, row0, col_tile * kTileCols,"
_PRODUCT = "  wgmma_s8<(S == kFirst && KS == 0) ? kCarry : 1>("
_SINGLE = """      NTT_K11_MMA(1, acc, 0)
      wgmma_wait<0>();  // D1
      fence_regs(acc);
      {
        const u32 keep = c > 0 ? ~0u : 0u;  // the carry, or 0 in chunk 0
#pragma unroll
        for (int e = 0; e < kAcc; ++e) t[e] = (t[e] & keep) + (acc[e] << kLimbBits);
      }
      NTT_K11_MMA(0, t, 1)  // E0
      NTT_K11_MMA(3, acc, 0)
      wgmma_wait<0>();  // E0, D3
      fence_regs(t);
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] <<= kLimbBits;
      NTT_K11_MMA(2, acc, 1)  // E2
      wgmma_wait<0>();
      fence_regs(acc);
      NTT_K11_FOLD(2)
      NTT_K11_MMA(5, acc, 0)
      wgmma_wait<0>();  // D5
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] <<= kLimbBits;
      NTT_K11_MMA(4, acc, 1)  // E4
      wgmma_wait<0>();
      fence_regs(acc);
      NTT_K11_FOLD(4)
      NTT_K11_MMA(6, acc, 0)
      wgmma_wait<0>();  // D6
      fence_regs(acc);
"""
# D1 and D3 in flight together, then D5 beside E2, D6 beside the fold of E2
_DOUBLE = """      u32 acc2[kAcc];
      NTT_K11_MMA(1, acc, 0)
      NTT_K11_MMA(3, acc2, 0)
      wgmma_wait<1>();  // D1
      fence_regs(acc);
      {
        const u32 keep = c > 0 ? ~0u : 0u;
#pragma unroll
        for (int e = 0; e < kAcc; ++e) t[e] = (t[e] & keep) + (acc[e] << kLimbBits);
      }
      NTT_K11_MMA(0, t, 1)  // E0
      wgmma_wait<1>();  // D3
      fence_regs(acc2);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc2[e] <<= kLimbBits;
      NTT_K11_MMA(2, acc2, 1)  // E2
      NTT_K11_MMA(5, acc, 0)
      wgmma_wait<1>();  // E0, E2
      fence_regs(t);
      fence_regs(acc2);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) t[e] += shoup_mul_q2<u32>(s.w[2], s.w_con[2], acc2[e], s.q);
      NTT_K11_MMA(6, acc2, 0)
      wgmma_wait<1>();  // D5
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] <<= kLimbBits;
      NTT_K11_MMA(4, acc, 1)  // E4
      wgmma_wait<1>();  // D6
      fence_regs(acc2);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) t[e] += shoup_mul_q2<u32>(s.w[6], s.w_con[6], acc2[e], s.q);
      wgmma_wait<0>();  // E4
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) t[e] += shoup_mul_q2<u32>(s.w[4], s.w_con[4], acc[e], s.q);
"""
# the last fold of the single-tile order, which _DOUBLE has done already
_LAST_FOLD = "      NTT_K11_FOLD(6)\n"

VARIANTS = {
    "as_is": [],
    "two_accumulators": [(_SINGLE, _DOUBLE), (_LAST_FOLD, "")],
    "no_fold": [(_FOLD, '_Pragma("unroll") for (int e = 0; e < kAcc; ++e) t[e] += acc[e];')],
    "no_staging": [(_STAGE, "      if (u == 0)\n" + _STAGE)],
    "no_store": [(_STORE, "    if (s.q == 0)\n" + _STORE)],
    "no_products": [(_PRODUCT, "  if (x_lo == 0xffffffffu)\n" + _PRODUCT)],
}
EXACT = ("as_is", "two_accumulators")


def build(names) -> dict:
    """{variant: (library path, ptxas lines of the right-contract scaled
    wgmma kernel)}; raises if a patch does not apply or nvcc fails."""
    src = (native.CSRC / "mxu.cu").read_text()
    out = native.BUILD / "k11_lab"
    out.mkdir(parents=True, exist_ok=True)
    cmds, paths = [], {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"k11_lab: variant {name} no longer applies to csrc/mxu.cu")
            text = text.replace(old, new)
        cu, so = out / f"mxu_{name}.cu", out / f"libmxu_{name}.so"
        cu.write_text(text)
        cmds.append([native.find_nvcc(), *native.COMPILE_FLAGS, *native.LINK_FLAGS[2:],
                     "-I", str(native.CSRC), str(cu), "-o", str(so)])
        paths[name] = so
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    built = {}
    for name, proc in zip(names, procs):
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"k11_lab: nvcc failed on {name}:\n{log}")
        ptxas, take = [], False
        for line in log.splitlines():
            if "entry function" in line:
                take = "limb_matmul_wgmmaILb0ELb1E" in line
            elif take and ("spill" in line or "Used" in line):
                ptxas.append(line.strip())
        built[name] = (paths[name], ptxas[-2:])
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    built = build(list(VARIANTS))
    libs = {}
    for name, (path, _) in built.items():
        cdll = ctypes.CDLL(str(path))
        for contract in mxu.CONTRACTS:
            fn = getattr(cdll, f"ntt_limb_matmul_{contract}_scaled")
            fn.argtypes = native.SIGNATURES[f"ntt_limb_matmul_{contract}_scaled"]
            fn.restype = ctypes.c_int
        libs[name] = cdll
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []
    for m, batch, q in SHAPES:
        p = NttParams.make(q, m) if q else NttParams.generate(28, m)
        n1, n2 = 1 << m // 2, 1 << (m - m // 2)
        x = torch.randint(0, p.q, (batch, n1, n2), generator=gen, device=dev, dtype=torch.int32)
        s_tab = torch.randint(0, p.q, (n1, n2), generator=gen, device=dev, dtype=torch.int32)
        s_con = ((s_tab.to(torch.int64) << 32) // p.q).to(torch.int32)
        for contract, k in (("left", n1), ("right", n2)):
            mat = torch.randint(0, 128, (4, k, k), generator=gen, device=dev, dtype=torch.int8)
            want = mxu.limb_matmul_plain(mat, x, p.q, contract, (s_tab, s_con))
            out = torch.empty_like(x)
            rows_arg = batch if contract == "left" else batch * n1
            f_log = (n2 if contract == "left" else n1).bit_length() - 1
            row = {"m": m, "batch": batch, "contract": contract}
            for name, cdll in libs.items():
                fn = getattr(cdll, f"ntt_limb_matmul_{contract}_scaled")

                def call(_, fn=fn):
                    err = fn(mat.data_ptr(), x.data_ptr(), out.data_ptr(), s_tab.data_ptr(),
                             s_con.data_ptr(), p.q, rows_arg, k.bit_length() - 1, f_log,
                             native.stream(dev))
                    if err:
                        raise RuntimeError(f"k11_lab {name}: launch failed, error {err}")

                call(None)
                torch.cuda.synchronize()
                if name in EXACT and not torch.equal(out, want):
                    raise AssertionError(f"k11_lab {name} m{m} {contract}: differs from plain")
                row[f"{name}_us"] = min(lab.cuda_us(call, None, 3, 5) for _ in range(2))
            rows.append(row)
            print(f"  m{m} b{batch} {contract}: " + ", ".join(
                f"{n} {row[n + '_us']:.1f}" for n in VARIANTS) + " us", flush=True)
        del x, s_tab, s_con, mat, want, out
        torch.cuda.empty_cache()
    print(json.dumps({"card": lab.card(dev), "ptxas": {n: b[1] for n, b in built.items()},
                      "times": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
