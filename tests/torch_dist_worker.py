"""One rank of the two-process gloo world of tests/test_torch_dist.py: it
joins the world, runs every entry point of ntt_tpu_torch.dist on the same
seeded input as the other rank (one shard a rank), and rank 0 saves the
gathered outputs for the test to check.  Imports torch, numpy and
ntt_tpu_torch only.

argv: coordinator_port num_processes rank output.npz
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from ntt_tpu_torch.dist import sixstep as dist  # noqa: E402
from ntt_tpu_torch.params import FIXTURES  # noqa: E402

port, nproc, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_multihost(f"127.0.0.1:{port}", nproc, rank, device="cpu")
try:
    mesh = dist.default_mesh()
    p = FIXTURES[1]  # m9, q = 0x10001: word 32
    rng = np.random.default_rng(42)  # the same input on every rank
    a = rng.integers(0, p.q, size=(4, p.n), dtype=np.uint64)
    b = rng.integers(0, p.q, size=(4, p.n), dtype=np.uint64)
    res = {"a": a, "b": b, "ranks": np.array([tdist.get_world_size(), mesh.size])}
    res["fwd"] = dist.dist_fwd_ntt(a, p, mesh)
    res["fwd_chunked"] = dist.dist_fwd_ntt(a, p, mesh, n1_log=4, n_chunks=2)
    res["inv"] = dist.dist_inv_ntt(res["fwd"], p, mesh, n_chunks=2)
    res["product"] = dist.dist_negacyclic_mul(a, b, p, mesh, n_chunks=2)
    res["rec_fwd"] = dist.dist_rec_fwd_ntt(a, p, mesh)
    res["rec_inv"] = dist.dist_rec_inv_ntt(res["rec_fwd"], p, mesh)
    res["batch_parallel"] = dist.batch_parallel_fwd(a, p, mesh)
    res["fwd_2d"] = dist.dist_fwd_ntt(a, p, dist.mesh_2d(2, 1), batch_axis="dp")
    if rank == 0:
        np.savez(out, **res)
finally:
    tdist.destroy_process_group()
