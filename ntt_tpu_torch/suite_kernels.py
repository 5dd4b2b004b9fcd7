"""The kernels each bench suite body launches, and their device time, on the card.

    python -m ntt_tpu_torch.suite_kernels [--m 14] [--batch 1024]
        [--bits 62,27] [--calls 3] [--out FILE]

For every body of ``bench.suite_bodies`` that the port runs at each
``bench_params(m, bits)``: two warm-up calls, then ``calls`` calls under
``torch.profiler`` (CPU and CUDA activities), and for each kernel (and
copy or fill) the trace shows on the card, its launches and its device
time a call, summed over its launches.  The sum over a body's kernels is
its kernels' device time a call, which ``bench --suite`` sets beside the
body's time from a CUDA graph.  One line a body on stdout (with the card's
name and power limit first); with ``--out`` the same as JSON.  Needs a
card: there is no CPU form.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import tempfile

import torch

from ntt_tpu_torch import bench, lab
from ntt_tpu_torch.params import bench_params
from ntt_tpu_torch.plan import get_plan

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_times(fn, x, calls: int) -> dict[str, list]:
    """{kernel name: [launches a call, device us a call]} of fn(x)."""
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    acc = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") in DEVICE_EVENTS:
            name = e["name"].split("(")[0].removeprefix("void ")
            acc[name][0] += 1
            acc[name][1] += e["dur"]
    return {k: [n // calls, round(us / calls, 1)] for k, (n, us) in acc.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=14)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--bits", default="62,27", help="comma list of q_bits")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("suite_kernels needs a CUDA card: torch.cuda.is_available() is false")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"suite bodies' kernels at m{args.m} batch {args.batch}, device us a call "
          f"(torch.profiler, {args.calls} calls after 2 warm-up calls) on {lab.card(dev)}",
          flush=True)
    out = {}
    for bits in map(int, args.bits.split(",")):
        p = bench_params(args.m, bits)
        xs = {64: bench.bench_input(p, args.batch, dev, wide=True),
              32: bench.bench_input(p, args.batch, dev)}
        for name, body in sorted(bench.suite_bodies(get_plan(p)).items()):
            if isinstance(body, str):
                continue
            fn, word = body
            rows = kernel_times(fn, xs[word], args.calls)
            total = round(sum(us for _, us in rows.values()), 1)
            out[f"q{bits} {name}"] = {"kernels_us": total, "kernels": rows}
            print(f"q{bits} {name}: {total} us: " + "; ".join(
                f"{k} x{n} {us}" for k, (n, us) in rows.items()), flush=True)
        del xs
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
