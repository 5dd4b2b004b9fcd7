"""Time K11 ``limb_matmul`` and the 'mxu' variant of one source tree on the card.

    python ntt_tpu_torch/k11_times.py [--root DIR] [--tag NAME] [--seed SEED]

Imports ``ntt_tpu_torch`` from DIR (default: the tree holding this file),
builds its kernels, and prints one JSON line of device times in us at the
shapes of ``chip_smoke.py``'s mxu timing (m14 batch 1024 at q = 0xfff0001,
m16 batch 128 and m20 batch 16 at the largest 28-bit NTT prime of N): K11
a launch of each contract as a transform's first pass runs it (left scaled
by T, right scaled by S) from a CUDA graph, ``torch._int_mm``'s four calls
on the same int8 operands (the tensor-core part alone, a yardstick the port
never calls), and one API call of the mxu forward, inverse and product
beside 'auto' and, at m14, K1.  Run it for two trees in one command, in
turns (A, B, B, A), to compare them on one card.  It needs a CUDA card and
exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

TIMED = ((14, 1024, 0xFFF0001), (16, 128, None), (20, 16, None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from ntt_tpu_torch import NttParams, api, lab, native
    from ntt_tpu_torch.kernels import fused, mxu
    from ntt_tpu_torch.plan import get_plan

    dev = torch.device("cuda", 0)
    res = native.build()
    native.lib()
    ptxas, name = [], None  # K11's instantiations: registers, shared memory, spills
    for ln in res.log.splitlines():
        if "entry function" in ln:
            name = ln.split("'")[1] if "limb_matmul" in ln else None
        elif name and ("spill" in ln or "Used" in ln):
            ptxas.append(f"{name}: {ln.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def int_mm_us(mat, x, contract):
        limbs = [((x >> (7 * s)) & 127).to(torch.int8) for s in range(4)]
        if contract == "left":
            rhs = torch.cat(limbs, dim=-1).transpose(0, 1).reshape(x.shape[1], -1).contiguous()
            calls = [(mat[s].contiguous(), rhs) for s in range(4)]
        else:
            lhs = torch.cat(limbs, dim=-2).reshape(-1, x.shape[-1]).contiguous()
            calls = [(lhs, mat[s].t().contiguous()) for s in range(4)]
        return lab.cuda_us(lambda _: [torch._int_mm(a, b) for a, b in calls], None, 3, 5)

    rows = []
    for m, batch, q in TIMED:
        p = NttParams.make(q, m) if q else NttParams.generate(28, m)
        plan = get_plan(p)
        x = torch.randint(0, p.q, (batch, p.n), generator=gen, device=dev, dtype=torch.int64)
        y = torch.randint(0, p.q, (batch, p.n), generator=gen, device=dev, dtype=torch.int64)
        x, y = x.to(torch.int32), y.to(torch.int32)
        f = api.fwd_ntt(x, p, "mxu")
        ft, it = plan.device_tables(dev).mxu(False), plan.device_tables(dev).mxu(True)
        n1, n2 = 1 << ft["n1_log"], p.n >> ft["n1_log"]
        passes = {"left": (ft["m1"], x.view(batch, n1, n2), (ft["t"], ft["t_con"])),
                  "right": (it["w2i"], f.view(batch, n1, n2), (it["s"], it["s_con"]))}
        row = {"m": m, "batch": batch, "q": hex(p.q)}
        for contract, (mat, arg, scale) in passes.items():
            row[f"k11_{contract}_us"] = min(lab.cuda_us(
                lambda _: mxu.limb_matmul(mat, arg, p.q, contract, scale), None, 3, 5)
                for _ in range(2))
            row[f"int_mm_{contract}_us"] = int_mm_us(mat, arg, contract)
        for d, fn, arg in (("fwd", lambda t, v: api.fwd_ntt(t, p, v), x),
                           ("inv", lambda t, v: api.inv_ntt(t, p, v), f)):
            for v in ("mxu", "auto"):
                row[f"{v}_{d}_us"] = lab.cuda_us(lambda t: fn(t, v), arg, 3, 5)
        for v in ("mxu", "auto"):
            row[f"{v}_product_us"] = lab.cuda_us(
                lambda _: api.negacyclic_mul(x, y, p, variant=v), None, 3, 3)
        if m <= fused.max_logn(32):
            row["k1_fwd_us"] = lab.cuda_us(lambda t: fused.fwd_fused(t, plan), x, 3, 5)
        rows.append(row)
        del x, y, f, passes
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": args.root, "card": smi, "ptxas": ptxas,
                      "times": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
