"""Time K4-K7 of one source tree on the card, whole polynomials.

    python ntt_tpu_torch/twopass_times.py [--root DIR] [--tag NAME] [--seed SEED]

Imports ``ntt_tpu_torch`` from DIR (default: the tree holding this file),
builds its kernels, and prints one JSON line of device times in us, each
the minimum over two passes of a CUDA graph of launches, at the shapes of
``chip_smoke.py``'s two-pass checks (m16 batch 128 and m20 batch 16 at
both widths, m24 batch 1 at word 64) and the API's split: K4, K5 in the
(N1, N2) and the kept (N2, N1) layout, K6 from both, K7.  It calls only
the wrappers' whole-polynomial arguments, which every tree since the
register rounds takes, so run it for two trees in one command, in turns
(A, B, B, A), to compare them on one card.  It needs a CUDA card and exits
2 without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

SHAPES = ((16, 62, 128), (16, 29, 128), (20, 62, 16), (20, 29, 16), (24, 62, 1))


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
    from ntt_tpu_torch import NttParams, bench_params, lab, native
    from ntt_tpu_torch.kernels import sixstep, twopass
    from ntt_tpu_torch.plan import get_plan

    dev = torch.device("cuda", 0)
    native.build()
    native.lib()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []
    for m, bits, batch in SHAPES:
        p = bench_params(m, 62) if bits == 62 else NttParams.generate(bits, m)
        plan = get_plan(p)
        n1 = sixstep.word_split(p.n, plan.word)
        a = torch.randint(0, p.q, (batch, p.n), generator=gen, device=dev, dtype=plan.dtype)
        c = twopass.fwd_cols(a, plan, n1)
        f = twopass.fwd_rows(c, plan, n1)
        ft = twopass.fwd_rows(c, plan, n1, keep_transposed=True)
        r = twopass.inv_rows(f, plan, n1)
        runs = {"K4": (lambda x: twopass.fwd_cols(x, plan, n1), a),
                "K5": (lambda x: twopass.fwd_rows(x, plan, n1), c),
                "K5 transposed": (lambda x: twopass.fwd_rows(x, plan, n1, keep_transposed=True),
                                  c),
                "K6": (lambda x: twopass.inv_rows(x, plan, n1), f),
                "K6 transposed": (lambda x: twopass.inv_rows(x, plan, n1, input_transposed=True),
                                  ft),
                "K7": (lambda x: twopass.inv_cols(x, plan, n1), r)}
        row = {"m": m, "word": plan.word, "batch": batch, "n1_log": n1}
        for name, (fn, x) in runs.items():
            row[name] = min(lab.cuda_us(fn, x, 3, lab.INNER) for _ in range(2))
        rows.append(row)
        del a, c, f, ft, r
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": args.root, "card": smi, "times_us": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
