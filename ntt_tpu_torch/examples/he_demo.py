"""End-to-end HE-style workload on the port: the RNS ciphertext-multiply core.

    python -m ntt_tpu_torch.examples.he_demo [--m 10] [--widths 30,30,30]
        [--batch 4] [--check] [--device cuda|cpu]

The counterpart of the JAX package's ``examples/he_demo.py``, on
``ntt_tpu_torch.rns.DeviceRnsTower``:

  1. build an RNS tower of NTT primes of one ring degree N = 2^m, one
     ``api.DeviceNtt`` a channel, its tables on the device;
  2. encode two batches of big-int polynomials into residue channels (on
     the host, exact Python ints);
  3. per channel, the negacyclic product on the device
     (``DeviceNtt.negacyclic``: forward NTT of both operands, pointwise
     product, inverse NTT, the intermediates in the transposed layout where
     the six-step serves);
  4. CRT-reconstruct the exact big-int product and verify it: with
     ``--check`` the first polynomial against the O(N^2) schoolbook
     negacyclic product over Python ints, else by re-encoding the product
     into the channels it came from.

It runs on the card by default and raises without one: ``--device cpu``
runs the plain PyTorch versions instead, and nothing falls back from one to
the other.  It prints the wall clock of steps 2-4 and, on the card, the
device time between two CUDA events around the transfers and the products,
beside the card's name and power limit (``lab.card``).  Both include the
first use of the kernels, which builds the kernel library with nvcc when no
build of these sources exists yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ntt_tpu_torch import lab
from ntt_tpu_torch.rns import DeviceRnsTower


def schoolbook_negacyclic(a, b, n: int) -> list[int]:
    """Exact big-int negacyclic product (X^n = -1)."""
    acc = [0] * n
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            if k < n:
                acc[k] += ai * int(b[j])
            else:
                acc[k - n] -= ai * int(b[j])
    return acc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--widths", default="30,30,30")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--check", action="store_true",
                    help="verify against the O(N^2) schoolbook product")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is false; "
                           "pass --device cpu to run the plain versions")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        where = (f"{lab.card(device)} (including the kernels' first use, which builds them "
                 "where no build of these sources exists)")
    else:
        where = "the CPU (plain versions)"

    widths = tuple(int(w) for w in args.widths.split(","))
    t0 = time.perf_counter()
    tower = DeviceRnsTower(args.m, q_bits=widths, device=device)
    n = tower.n
    print(f"tower: N=2^{args.m}, moduli {[hex(q) for q in tower.moduli]} "
          f"(capacity {tower.modulus_product.bit_length()} bits, built in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    rng = np.random.default_rng(0)
    # coefficients up to about sqrt(capacity) / N, so that the integer
    # product stays below the moduli's product
    coef_bits = (tower.modulus_product.bit_length() - args.m - 2) // 2
    hi = 1 << min(coef_bits, 62)
    a = rng.integers(0, hi, size=(args.batch, n), dtype=np.uint64)
    b = rng.integers(0, hi, size=(args.batch, n), dtype=np.uint64)

    t0 = time.perf_counter()
    ch_a, ch_b = tower.encode(a), tower.encode(b)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    prod_ch = tower.to_host(tower.negacyclic(tower.from_host(ch_a), tower.from_host(ch_b)))
    device_ms = None
    if device.type == "cuda":
        end.record()
        end.synchronize()
        device_ms = start.elapsed_time(end)
    prod = tower.decode(prod_ch)
    wall_s = time.perf_counter() - t0
    timing = f"{wall_s:.3f} s wall clock"
    if device_ms is not None:
        timing += f", {device_ms:.3f} ms between CUDA events"
    print(f"{args.batch} ciphertext-style products x {len(widths)} channels: {timing}, "
          f"on {where}", flush=True)

    if args.check:
        want = schoolbook_negacyclic(a[0], b[0], n)
        big_q = tower.modulus_product
        got = [int(x) for x in prod[0]]
        if got != [w % big_q for w in want]:
            raise AssertionError("MISMATCH vs the schoolbook negacyclic product")
        print("verified: exact match with the schoolbook negacyclic product", flush=True)
    else:
        # re-encoding the reconstructed product gives back exactly the
        # channel residues it was built from
        np.testing.assert_array_equal(tower.encode(prod), prod_ch)
        print("self-check ok (run with --check for the schoolbook oracle)", flush=True)
    return {"moduli": tower.moduli, "product": prod, "wall_s": wall_s,
            "device_ms": device_ms, "checked": args.check, "where": where}


if __name__ == "__main__":
    main()
