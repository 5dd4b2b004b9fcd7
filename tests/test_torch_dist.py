"""The port's distributed six-step (ntt_tpu_torch/dist/sixstep.py) on the
CPU: its entry points on a local mesh bit for bit against the JAX dist
functions on conftest's 8-device virtual mesh, every other case against
the port's flat 'sixstep' (which the other test_torch_ files hold against
JAX), the shard forms of K4-K8's plain versions against slices of the
whole-polynomial passes, what the shard wrappers launch, and one
two-process gloo world (tests/torch_dist_worker.py).

The JAX calls run at m <= 10, once each through module-scoped fixtures,
most at the configurations tests/test_dist.py compiles (FIXTURES[2] on
the 8-device mesh, batch 2), whose jitted programs that file leaves in the
process.  Tolerance: none, every comparison is bit for bit."""

import contextlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_input

from ntt_tpu import refmodel as rm
from ntt_tpu.dist import sixstep as jdist
from ntt_tpu.params import FIXTURES as JFIXTURES
from ntt_tpu.params import NttParams as JNttParams
from ntt_tpu.params import dist_params as jdist_params
from ntt_tpu_torch import api, native, trace
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.dist import sixstep as dist
from ntt_tpu_torch.kernels import rec, sixstep, twopass
from ntt_tpu_torch.kernels.elems import pick_ops
from ntt_tpu_torch.params import FIXTURES, NttParams, dist_params, from_fields
from ntt_tpu_torch.plan import get_plan

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")

P32 = FIXTURES[2]  # m10, q = 0x10001: word 32
P64 = NttParams.generate(62, 8)  # word 64
P64_JAX = NttParams.generate(62, 6)  # the JAX word-64 call: its compile grows with m
WIDTHS = {"w32": P32, "w64": P64}


def rand(p, batch, seed, hi=None):
    return np.random.default_rng(seed).integers(0, hi or p.q, size=(batch, p.n), dtype=np.uint64)


def cpu_mesh(n):
    return dist.default_mesh(n, device="cpu")


def flat_fwd(a, p, lazy=False):
    return api.fwd_ntt(a, p, "sixstep", lazy=lazy, device="cpu")


# -- against the JAX dist functions ---------------------------------------------

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def jax_outs():
    """Each JAX dist entry point once on seeded inputs: (port call, JAX
    output).  The FIXTURES[2] calls at D = 8 (and D = 2 for rec) are
    tests/test_dist.py's configurations."""
    jp32, jp64 = JFIXTURES[2], JNttParams.generate(62, 6)
    x32, y32 = rand(P32, 2, 1), rand(P32, 2, 2)
    x64 = rand(P64_JAX, 4, 3)
    m8, m2d = jdist.default_mesh(8), jdist.mesh_2d(2, 2)
    f32 = jdist.dist_fwd_ntt(x32, jp32, mesh=m8)
    out = {
        "fwd strict w32 D8": (lambda: dist.dist_fwd_ntt(x32, P32, cpu_mesh(8)), f32),
        "inv w32 D8": (lambda: dist.dist_inv_ntt(f32, P32, cpu_mesh(8)),
                       jdist.dist_inv_ntt(f32, jp32, mesh=m8)),
        "inv w32 D4 n_chunks 2": (
            lambda: dist.dist_inv_ntt(y32, P32, cpu_mesh(4), n_chunks=2),
            jdist.dist_inv_ntt(y32, jp32, mesh=jdist.default_mesh(4), n_chunks=2)),
        "polymul w32 D8": (lambda: dist.dist_negacyclic_mul(x32, y32, P32, cpu_mesh(8)),
                           jdist.dist_negacyclic_mul(x32, y32, jp32, mesh=m8)),
        "rec fwd w32 D2": (lambda: dist.dist_rec_fwd_ntt(x32, P32, cpu_mesh(2)),
                           jdist.dist_rec_fwd_ntt(x32, jp32, mesh=jdist.default_mesh(2))),
        "rec inv w32 D8": (lambda: dist.dist_rec_inv_ntt(f32, P32, cpu_mesh(8)),
                           jdist.dist_rec_inv_ntt(f32, jp32, mesh=m8)),
        "batch-parallel w32 D8": (
            lambda: dist.batch_parallel_fwd(np.concatenate([x32] * 4), P32, cpu_mesh(8)),
            jdist.batch_parallel_fwd(np.concatenate([x32] * 4), jp32, mesh=m8)),
        "fwd lazy w64 2-D (2, 2)": (
            lambda: dist.dist_fwd_ntt(x64, P64_JAX, dist.mesh_2d(2, 2, device="cpu"), n1_log=3,
                                      lazy=True, batch_axis="dp"),
            jdist.dist_fwd_ntt(x64, jp64, mesh=m2d, n1_log=3, lazy=True, batch_axis="dp")),
    }
    return out


@needs_8
@pytest.mark.parametrize("call", ["fwd strict w32 D8", "inv w32 D8", "inv w32 D4 n_chunks 2",
                                  "polymul w32 D8", "rec fwd w32 D2", "rec inv w32 D8",
                                  "batch-parallel w32 D8", "fwd lazy w64 2-D (2, 2)"])
def test_dist_equals_jax(jax_outs, call):
    port, want = jax_outs[call]
    got = port()
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_dist_params_equal_jax():
    assert dist_params(20) == from_fields(jdist_params(20))
    assert dist_params(20, 62) == from_fields(jdist_params(20, 62))


# -- against the port's flat six-step -------------------------------------------


# (width, D, n_chunks) with D x n_chunks dividing N1 = N2 = 2^(m/2): 2^5 at
# word 32 (m10), 2^4 at word 64 (m8)
FLAT_CASES = [(w, d, c) for w, p in WIDTHS.items() for d in (1, 2, 4, 8) for c in (1, 2, 4)
              if (1 << p.m // 2) % (d * c) == 0]


@pytest.mark.parametrize("width,ndev,n_chunks", FLAT_CASES)
def test_dist_fwd_inv_product_equal_flat(width, ndev, n_chunks):
    """Forward strict and lazy, inverse and product at a split with room for
    the chunks."""
    p = WIDTHS[width]
    mesh, n1_log = cpu_mesh(ndev), p.m // 2
    a, b = rand(p, 2, 10 + ndev), rand(p, 2, 20 + ndev)
    kw = dict(n1_log=n1_log, n_chunks=n_chunks)
    f = dist.dist_fwd_ntt(a, p, mesh, **kw)
    np.testing.assert_array_equal(f, flat_fwd(a, p))
    np.testing.assert_array_equal(dist.dist_fwd_ntt(a, p, mesh, lazy=True, **kw),
                                  flat_fwd(a, p, lazy=True))
    np.testing.assert_array_equal(dist.dist_inv_ntt(f, p, mesh, **kw), a)
    np.testing.assert_array_equal(dist.dist_negacyclic_mul(a, b, p, mesh, **kw),
                                  api.negacyclic_mul(a, b, p, device="cpu"))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_dist_default_split_and_rec_equal_flat(width, ndev):
    """The default splits (JAX's, N1 raised to D), the two-level path
    strict, lazy (< 4q, equal mod q) and back, and batch-parallel."""
    p = WIDTHS[width]
    mesh = cpu_mesh(ndev)
    a = rand(p, 8, 30 + ndev)
    want = flat_fwd(a, p)
    f = dist.dist_fwd_ntt(a, p, mesh)
    np.testing.assert_array_equal(f, want)
    np.testing.assert_array_equal(dist.dist_inv_ntt(f, p, mesh), a)
    r = dist.dist_rec_fwd_ntt(a, p, mesh)
    np.testing.assert_array_equal(r, want)
    np.testing.assert_array_equal(dist.dist_rec_inv_ntt(r, p, mesh), a)
    lazy = dist.dist_rec_fwd_ntt(a, p, mesh, lazy=True)
    np.testing.assert_array_equal(lazy % np.uint64(p.q), want)
    assert lazy.max() < 4 * p.q
    np.testing.assert_array_equal(dist.batch_parallel_fwd(a, p, mesh), want)
    np.testing.assert_array_equal(dist.batch_parallel_fwd(a, p, mesh, lazy=True),
                                  flat_fwd(a, p, lazy=True))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("width", WIDTHS)
def test_dist_2d_mesh_equal_flat(shape, width):
    """dp x sp: the batch data parallel over 'dp', each transform sharded
    over 'x', through every entry point that takes batch_axis."""
    p = WIDTHS[width]
    mesh = dist.mesh_2d(*shape, device="cpu")
    a, b = rand(p, 4, 40), rand(p, 4, 41)
    f = dist.dist_fwd_ntt(a, p, mesh, batch_axis="dp")
    np.testing.assert_array_equal(f, flat_fwd(a, p))
    np.testing.assert_array_equal(dist.dist_inv_ntt(f, p, mesh, batch_axis="dp"), a)
    np.testing.assert_array_equal(dist.dist_negacyclic_mul(a, b, p, mesh, batch_axis="dp"),
                                  api.negacyclic_mul(a, b, p, device="cpu"))
    r = dist.dist_rec_fwd_ntt(a, p, mesh, batch_axis="dp")
    np.testing.assert_array_equal(r, f)
    np.testing.assert_array_equal(dist.dist_rec_inv_ntt(r, p, mesh, batch_axis="dp"), a)


@pytest.mark.parametrize("n1_log", [3, 5, 7])
def test_dist_custom_split(n1_log):
    p = P32
    a = rand(p, 1, 50)[0]  # no batch dim: the shape comes back as it went in
    f = dist.dist_fwd_ntt(a, p, cpu_mesh(4), n1_log=n1_log)
    assert f.shape == a.shape
    np.testing.assert_array_equal(f, flat_fwd(a[None], p)[0])
    np.testing.assert_array_equal(dist.dist_inv_ntt(f, p, cpu_mesh(4), n1_log=n1_log), a)


def test_dist_large_n_against_refmodel():
    """dist_params(m) at m = 16 (the m20-m24 cases' q at a CPU-sized N):
    the D = 8 forward against refmodel, the round trip exact."""
    p = dist_params(16)
    plan = get_plan(p)
    a = make_input(np.random.default_rng(60), p.n, p.q, batch=1)
    f = dist.dist_fwd_ntt(a, p, cpu_mesh(8), n_chunks=2)
    np.testing.assert_array_equal(f, rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con))
    np.testing.assert_array_equal(dist.dist_inv_ntt(f, p, cpu_mesh(8), n_chunks=2), a)


def test_dist_tensors_in_tensors_out():
    """Tensors are transformed into tensors on their device, in the plan's
    rep; the plan may be a plan or params."""
    p = P64
    plan = get_plan(p)
    a = rand(p, 2, 70)
    x = mm.from_host(a, p.q, "cpu")
    f = dist.dist_fwd_ntt(x, plan, cpu_mesh(4))
    assert isinstance(f, torch.Tensor) and f.dtype == plan.dtype and f.shape == x.shape
    np.testing.assert_array_equal(mm.to_host(f), flat_fwd(a, p))
    assert torch.equal(dist.dist_inv_ntt(f, p, cpu_mesh(4)), x)
    with pytest.raises(TypeError):
        dist.dist_negacyclic_mul(x, a, p, cpu_mesh(2))
    with pytest.raises(TypeError):
        dist.dist_fwd_ntt(x.to(torch.int32), p, cpu_mesh(2))


def test_dist_raises_on_what_it_cannot_shard():
    p = P32
    a = rand(p, 2, 80)
    with pytest.raises(ValueError, match="divide by mesh size"):
        dist.dist_fwd_ntt(a, p, cpu_mesh(8), n1_log=2)
    with pytest.raises(ValueError, match="mesh\\*chunks"):
        dist.dist_fwd_ntt(a, p, cpu_mesh(4), n1_log=3, n_chunks=4)
    with pytest.raises(ValueError, match="mesh\\*chunks"):
        dist.dist_inv_ntt(a, p, cpu_mesh(8), n1_log=7, n_chunks=2)
    with pytest.raises(ValueError, match="batch 2 must divide"):
        dist.dist_fwd_ntt(a, p, dist.mesh_2d(4, 2, device="cpu"), batch_axis="dp")
    with pytest.raises(ValueError, match="leading batch dim"):
        dist.batch_parallel_fwd(a, p, cpu_mesh(4))
    with pytest.raises(ValueError, match="transform axis"):
        dist.dist_fwd_ntt(a, p, cpu_mesh(2), axis="y")
    with pytest.raises(ValueError, match="last dim"):
        dist.dist_fwd_ntt(a[:, :-1], p, cpu_mesh(2))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """With no mesh the entry points build default_mesh(device="cuda"),
    which raises where there is no card; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = rand(P32, 2, 90)
    for call in (lambda: dist.dist_fwd_ntt(a, P32), lambda: dist.dist_inv_ntt(a, P32),
                 lambda: dist.dist_negacyclic_mul(a, a, P32),
                 lambda: dist.dist_rec_fwd_ntt(a, P32), lambda: dist.batch_parallel_fwd(a, P32),
                 lambda: dist.mesh_2d(2, 4), lambda: dist.init_multihost("localhost:1", 1, 0)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_mesh_shapes():
    m = dist.mesh_2d(2, 4, device="cpu")
    assert m.shape == {"dp": 2, "x": 4} and m.size == 8 and m.rank is None
    assert m.coords(6) == {"dp": 1, "x": 2}
    lines = m.lines("x")
    assert [members for members, _ in lines] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [members for members, _ in m.lines("dp")] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert cpu_mesh(None).shape == {"x": 1}


# -- the shard forms of the kernels' plain versions -------------------------------


def _case(width):
    p = WIDTHS[width]
    plan = get_plan(p)
    return p, plan, pick_ops(p.q), plan.device_tables("cpu")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("transposed", [False, True], ids=["std", "transposed"])
def test_row_shards_equal_rows_of_the_whole(width, transposed):
    """K5 (strict and lazy) and K6 at every row0 of D = 4, and at chunks of
    2 rows, through the wrappers' CPU route and the plain functions: the
    shard's rows of the whole polynomial's pass."""
    p, plan, ops, tabs = _case(width)
    n1_log = p.m // 2
    n1, n2 = 1 << n1_log, p.n >> n1_log
    a = mm.from_host(rand(p, 3, 100, hi=4 * p.q), p.q, "cpu")
    whole = {s: sixstep.fwd_rows(a, ops, tabs.w, tabs.w_con, p.q, n1_log, s)
             for s in (True, False)}
    whole_inv = sixstep.inv_rows(a, ops, tabs.w_inv, tabs.w_inv_con, p.q, n1_log)
    for rows_log in (n1_log - 2, 1):
        rows = 1 << rows_log
        for row0 in range(0, n1, rows):
            shard = a.view(3, n1, n2)[:, row0:row0 + rows].reshape(3, -1)
            for strict in (True, False):
                got = twopass.fwd_rows(shard, plan, n1_log, strict, transposed, row0, rows_log)
                want = whole[strict].view(3, n1, n2)[:, row0:row0 + rows]
                if transposed:
                    want = want.transpose(1, 2)
                assert torch.equal(got, want.reshape(3, -1)), (rows_log, row0, strict)
            src = shard.view(3, rows, n2).transpose(1, 2).reshape(3, -1) if transposed else shard
            got = twopass.inv_rows(src, plan, n1_log, transposed, row0, rows_log)
            want = whole_inv.view(3, n1, n2)[:, row0:row0 + rows].reshape(3, -1)
            assert torch.equal(got, want), (rows_log, row0)
            assert torch.equal(got, sixstep.inv_rows(src, ops, tabs.w_inv, tabs.w_inv_con, p.q,
                                                     n1_log, transposed, row0, rows_log))


@pytest.mark.parametrize("width", WIDTHS)
def test_lane_shards_equal_lanes_of_the_whole(width):
    """K4 and K7 on N2/D lanes (D = 2, 4, 8) equal those lanes of the whole
    pass: K7 with the whole transform's n^-1 constants, also with the
    level-1 plan of the two-level form."""
    p, plan, ops, tabs = _case(width)
    n1_log = p.m // 2
    n1, n2 = 1 << n1_log, p.n >> n1_log
    a = mm.from_host(rand(p, 2, 110, hi=4 * p.q), p.q, "cpu")
    strict_in = mm.from_host(rand(p, 2, 111), p.q, "cpu")
    plan1 = plan.rec_plans(n1_log)[0]
    wholes = (twopass.fwd_cols(a, plan, n1_log), twopass.inv_cols(strict_in, plan, n1_log),
              twopass.fwd_cols(a, plan, n1_log, plan1),
              twopass.inv_cols(strict_in, plan, n1_log, plan1))
    for d in (2, 4, 8):
        lanes = n2 // d
        for j in range(d):
            def cut(t):
                return t.view(2, n1, n2)[..., j * lanes:(j + 1) * lanes].reshape(2, -1)
            lg = lanes.bit_length() - 1
            got = (twopass.fwd_cols(cut(a), plan, n1_log, n2_log=lg),
                   twopass.inv_cols(cut(strict_in), plan, n1_log, n2_log=lg),
                   twopass.fwd_cols(cut(a), plan, n1_log, plan1, lg),
                   twopass.inv_cols(cut(strict_in), plan, n1_log, plan1, lg))
            for g, w in zip(got, wholes):
                assert torch.equal(g, cut(w)), (d, j)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("inverse", [False, True])
def test_twist_row_shards_equal_rows_of_the_whole(width, inverse):
    """K8 on a row shard: the shard's rows of the whole twist, the tables
    from row row0."""
    p, plan, _, _ = _case(width)
    l1 = sixstep.rec_split(p.m)
    n1, n2 = 1 << l1, p.n >> l1
    a = mm.from_host(rand(p, 2, 120, hi=4 * p.q), p.q, "cpu")
    whole = rec.twist_mul(a, plan, l1, inverse).view(2, n1, n2)
    for rows_log in (0, l1 - 3):
        rows = 1 << rows_log
        for row0 in range(0, n1, rows):
            shard = a.view(2, n1, n2)[:, row0:row0 + rows].reshape(2, -1)
            got = rec.twist_mul(shard, plan, l1, inverse, row0, rows_log)
            assert torch.equal(got, whole[:, row0:row0 + rows].reshape(2, -1)), (rows_log, row0)


def test_shard_wrappers_reject_what_they_cannot_take():
    p, plan, _, _ = _case("w32")
    n1_log = 5
    x = torch.zeros(2, 1 << 8, dtype=plan.dtype)  # 8 rows of N2 = 32
    with pytest.raises(ValueError, match="outside the"):
        twopass.fwd_rows(x, plan, n1_log, row0=28, rows_log=3)
    with pytest.raises(ValueError, match="outside the"):
        twopass.inv_rows(x, plan, n1_log, row0=0, rows_log=6)
    with pytest.raises(ValueError, match="last dim"):
        twopass.fwd_rows(x, plan, n1_log, row0=0, rows_log=2)
    with pytest.raises(ValueError, match="lanes"):
        twopass.fwd_cols(x, plan, n1_log, n2_log=6)
    with pytest.raises(ValueError, match="last dim"):
        twopass.inv_cols(x, plan, n1_log, n2_log=2)
    with pytest.raises(ValueError, match="outside the"):
        rec.twist_mul(x, plan, 5, row0=30, rows_log=3)


@pytest.fixture
def fake_card(monkeypatch):
    """Route CPU tensors to the wrappers' kernel branch and record each
    launch that reaches the library through native.launch (which counts
    it in trace.LAUNCHES), its arguments checked against native.SIGNATURES."""
    launched = []

    class Library:
        def __getattr__(self, entry):
            def launcher(*args):
                assert len(args) == len(native.SIGNATURES[entry]), entry
                launched.append((entry.removeprefix("ntt_"), args))
                return 0

            return launcher

    monkeypatch.setattr(native, "route", lambda t: "cuda")
    monkeypatch.setattr(native, "lib", Library)
    monkeypatch.setattr(native, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return launched


@pytest.mark.parametrize("width", WIDTHS)
def test_shard_launch_arguments(fake_card, width):
    """The shard launches carry the global n1_log, the shard's rows_log and
    row0 (K5 / K6), the shard's lanes (K4 / K7) and the shard's batch and
    geometry; the tile picker takes the local counts."""
    p, plan, _, _ = _case(width)
    n1_log, n2_log = p.m // 2, p.m - p.m // 2
    word = plan.word
    rows = torch.zeros(3, 2 << n2_log, dtype=plan.dtype)  # two rows
    lanes = torch.zeros(3, 4 << n1_log, dtype=plan.dtype)  # four lanes
    before = trace.LAUNCHES.copy()
    twopass.fwd_rows(rows, plan, n1_log, True, True, row0=6, rows_log=1)
    twopass.inv_rows(rows, plan, n1_log, False, row0=4, rows_log=1)
    twopass.fwd_cols(lanes, plan, n1_log, n2_log=2)
    twopass.inv_cols(lanes, plan, n1_log, n2_log=2)
    rec.twist_mul(rows, plan, n1_log, row0=2, rows_log=1)
    (k5, a5), (k6, a6), (k4, a4), (k7, a7), (k8, a8) = fake_card
    assert (k5, k6, k4, k7, k8) == tuple(f"{k}_u{word}" for k in (
        "fwd_rows", "inv_rows", "fwd_cols", "inv_cols", "twist_mul"))
    tr5 = twopass.round_tile_log(1, n2_log, word, rows=True, transposed=True)
    assert a5[5:-1] == (3, n1_log, 1, 6, n2_log, tr5, 1, 1)
    tr6 = twopass.round_tile_log(1, n2_log, word, rows=True)
    assert a6[5:-1] == (3, n1_log, 1, 4, n2_log, tr6, 0)
    tc = twopass.round_tile_log(n1_log, 2, word, rows=False)
    assert a4[5:-1] == (3, n1_log, 2, tc)
    assert a7[10:-1] == (3, n1_log, 2, tc)
    assert a7[5:7] == (plan.inv_consts[0], plan.inv_consts[1])  # the whole transform's n^-1
    assert a8[7:-1] == (3, 1 + n2_log, 1)  # batch, the shard's m, its rows
    tabs = plan.device_tables("cpu").twist(n1_log, False)
    assert a8[2] == tabs[0][2:].data_ptr() and a8[4] == tabs[2][2:].data_ptr()
    names = [f"{k}_u{word}" for k in ("fwd_rows", "inv_rows", "fwd_cols", "inv_cols",
                                      "twist_mul")]
    assert trace.LAUNCHES - before == {**{k: 1 for k in names},
                                       **{f"shard/{k}": 1 for k in names}}
    shards = trace.LAUNCHES.copy()
    twopass.fwd_rows(torch.zeros(1, p.n, dtype=plan.dtype), plan, n1_log)  # a whole polynomial
    assert trace.LAUNCHES - shards == {f"fwd_rows_u{word}": 1}


# -- a two-process gloo world ----------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world(tmp_path):
    """Two ranks of a gloo world (one shard each, all_to_all_single across
    the processes) run every entry point on the same seeded input; rank 0
    saves the outputs, held here against refmodel and the port's flat
    path."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("NTT_MULMOD", None)
    out = tmp_path / "rank0.npz"
    procs = [subprocess.Popen([sys.executable, WORKER, str(port), "2", str(rank), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env) for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=60)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    got = np.load(out)
    p = FIXTURES[1]
    plan = get_plan(p)
    a, b = got["a"], got["b"]
    want = rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con)
    for key in ("fwd", "fwd_chunked", "rec_fwd", "batch_parallel", "fwd_2d"):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    for key in ("inv", "rec_inv"):
        np.testing.assert_array_equal(got[key], a, err_msg=key)
    np.testing.assert_array_equal(got["product"], api.negacyclic_mul(a, b, p, device="cpu"))
    assert got["ranks"].tolist() == [2, 2]
