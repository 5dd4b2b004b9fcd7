"""Time the lab's transforms of one source tree on the card.

    python ntt_tpu_torch/lab_times.py [--root DIR] [--tag NAME] [--seed SEED]

Imports ``ntt_tpu_torch`` from DIR (default: the tree holding this file),
builds its kernels, and prints one JSON line of device times in us a call,
each the minimum over two passes of a CUDA graph of launches
(``lab.cuda_us``), of K1 (``v1``), L1 in rounds of one and two stages
(``v2-r2``, ``v2-r4``), L2 (``v3``) and the four L3 probes
(``diag-copy``, ``diag-mul``, ``diag-math`` at m rounds, ``diag-moves``)
at the lab's shapes: m14 batch 512 at both widths with the Shoup product,
and under the NTT_MULMOD=solinas switch the word-64 q at m14 batch 512 and
the word-32 q at m10 batch 8192 (the lab's q where the switch takes the
Solinas product).  It calls only
``lab.candidates`` and ``lab.case_params``, which every tree since the
lab's Solinas instantiations has, so run it for two trees in one command,
in turns (A, B, B, A), to compare them on one card.  It needs a CUDA card
and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

# (case, m, batch, Solinas switch)
SHAPES = (("u64", 14, 512, False), ("u32", 14, 512, False), ("u64", 14, 512, True),
          ("u32", 10, 8192, True))
NAMES = ("v1", "v2-r2", "v2-r4", "v3", "diag-copy", "diag-mul", "diag-math", "diag-moves")


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
    from ntt_tpu_torch import lab, native
    from ntt_tpu_torch import modmath as mm
    from ntt_tpu_torch.plan import get_plan

    dev = torch.device("cuda", 0)
    native.build()
    native.lib()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []
    try:
        for case, m, batch, solinas in SHAPES:
            mm.USE_SOLINAS = solinas
            p = lab.case_params(case, m)
            plan = get_plan(p)
            sol = mm.solinas_args(plan.q, plan.word)
            if bool(sol) != solinas:
                raise AssertionError(f"q {p.q:#x} m{m}: Solinas product {sol}, wanted {solinas}")
            x = torch.randint(0, p.q, (batch, p.n), generator=gen, device=dev, dtype=plan.dtype)
            cands = lab.candidates(plan, lab.lab_split(m))
            row = {"word": plan.word, "m": m, "batch": batch, "q": hex(p.q),
                   "product": "Solinas" if sol else "Shoup"}
            for name in NAMES:
                row[name] = min(lab.cuda_us(cands[name].fn, x, 3, lab.INNER) for _ in range(2))
            rows.append(row)
            del x
    finally:
        mm.USE_SOLINAS = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": args.root, "card": smi, "times_us": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
