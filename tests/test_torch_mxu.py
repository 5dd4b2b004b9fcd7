"""The port's 'mxu' variant on the CPU: its tables, K11's plain version and
the variant through the API, bit for bit against the JAX package
(``ntt_tpu.kernels.mxu``'s builders and ``_matmul_mod_q``, and
``api.fwd_ntt`` / ``inv_ntt`` / ``negacyclic_mul`` with
``variant="mxu"``, all jnp), against Python ints, and strict against the
port's 'sixstep'.  Tolerance everywhere: none, bit-exact.  The JAX calls
run once per (q, m) in module-scoped fixtures, at m <= 9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu.kernels import mxu as jmxu
from ntt_tpu.params import FIXTURES as JFIXTURES
from ntt_tpu.params import NttParams as JNttParams
from ntt_tpu_torch import api, trace
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import twiddles as ttw
from ntt_tpu_torch.kernels import mxu
from ntt_tpu_torch.params import from_fields
from ntt_tpu_torch.plan import NttPlan, get_plan

# odd and even m, N1 = 1 at m1; the reference fixtures 0 and 1 (m8 / m9)
GENERATED_M = (1, 2, 5, 8, 9)
CASES = [("gen", m) for m in GENERATED_M] + [("fixture", 0), ("fixture", 1)]
BATCH = 3


def jp_of(kind, i):
    return JNttParams.generate(28, i) if kind == "gen" else JFIXTURES[i]


def rand(q, shape, seed):
    return np.random.default_rng(seed).integers(0, q, size=shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def jax_transforms():
    """(jp, a, JAX forward, JAX inverse of b, b) for every case: one JAX
    forward and inverse a (q, m)."""
    out = {}
    for kind, i in CASES:
        jp = jp_of(kind, i)
        a, b = rand(jp.q, (BATCH, jp.n), 10 + i), rand(jp.q, (BATCH, jp.n), 40 + i)
        out[kind, i] = (jp, a, jax_api.fwd_ntt(a, jp, variant="mxu"),
                        jax_api.inv_ntt(b, jp, variant="mxu"), b)
    return out


@pytest.mark.parametrize("m", (1, 2, 5, 8, 9, 12))
@pytest.mark.parametrize("inverse", (False, True), ids=("fwd", "inv"))
def test_tables_equal_jax(m, inverse):
    """The port's vectorised builders against build_mxu_tables /
    build_mxu_inv_tables (numpy), and tables_from_numpy of JAX's."""
    jp = JNttParams.generate(28, m)
    build = jmxu.build_mxu_inv_tables if inverse else jmxu.build_mxu_tables
    want = {k: v if k == "n1_log" else np.asarray(v)
            for k, v in build(jp.q, jp.w, jp.n, ttw.mxu_split(jp.n)).items()}
    got = ttw.mxu_tables(jp.w, jp.q, jp.n, inverse)
    carried = mxu.tables_from_numpy(want)
    assert set(got) == set(want) == set(carried)
    assert got["n1_log"] == carried["n1_log"] == m // 2
    for k in set(got) - {"n1_log"}:
        assert got[k].dtype == carried[k].dtype == (np.int8 if want[k].dtype == np.int8
                                                     else np.uint64), k
        np.testing.assert_array_equal(got[k].astype(np.uint64), want[k].astype(np.uint64))
        np.testing.assert_array_equal(carried[k], got[k])


def test_plan_takes_jax_tables():
    """NttPlan.from_numpy with the JAX tables under "mxu" / "mxu_inv"
    computes what the port's own plan computes; wrong shapes raise."""
    jp = JNttParams.generate(28, 6)
    p = from_fields(jp)
    own = get_plan(p)
    tables = own.host_tables()
    tables["mxu"] = mxu.tables_from_numpy(
        {k: v if k == "n1_log" else np.asarray(v)
         for k, v in jmxu.get_mxu_tables(jp.q, jp.w, jp.n).items()})
    plan = NttPlan.from_numpy(p, tables)
    a = rand(p.q, (2, p.n), 5)
    np.testing.assert_array_equal(api.fwd_ntt(a, plan, "mxu", device="cpu"),
                                  api.fwd_ntt(a, own, "mxu", device="cpu"))
    tables["mxu"] = dict(tables["mxu"], t=tables["mxu"]["t"][:, :4])
    with pytest.raises(ValueError, match="split"):
        NttPlan.from_numpy(p, tables)


def python_matmul_mod(mat, x, q, contract):
    """(mat @ x) mod q over Python ints (object arrays)."""
    m, xo = mat.astype(object), x.astype(object)
    return (np.einsum("jk,bki->bji", m, xo) if contract == "left"
            else np.einsum("bik,jk->bij", xo, m)) % q


@pytest.fixture(scope="module")
def matmul_cases():
    """For each contract: (mat, its limbs, x, JAX's _matmul_mod_q) at a
    28-bit q, K = 16 (left) / 32 (right), two polynomials."""
    q = JNttParams.generate(28, 9).q
    out = {}
    for contract, (k, f) in (("left", (16, 32)), ("right", (32, 16))):
        mat = rand(q, (k, k), 1)
        x = rand(q, (2, k, f) if contract == "left" else (2, f, k), 2)
        limbs = jmxu._limbs_of_matrix(mat)
        jx = jnp.asarray(x.astype(np.uint32))
        want = np.asarray(jmxu._matmul_mod_q(jnp.asarray(limbs), jx, q, contract))
        out[contract] = (q, mat, limbs, x, want.astype(np.uint64))
    return out


@pytest.mark.parametrize("contract", mxu.CONTRACTS)
@pytest.mark.parametrize("scaled", (False, True), ids=("plain", "scaled"))
def test_limb_matmul_plain(matmul_cases, contract, scaled):
    """limb_matmul_plain (and the wrapper, on CPU tensors) against JAX's
    _matmul_mod_q and Python ints; with the scale, the strict product by the
    (N1, N2) table after it."""
    q, mat, limbs, x, want = matmul_cases[contract]
    np.testing.assert_array_equal(want, python_matmul_mod(mat, x, q, contract))
    scale = None
    if scaled:
        s = rand(q, x.shape[1:], 3)
        want = want * s % np.uint64(q)
        s_con = (s << np.uint64(32)) // np.uint64(q)  # q < 2^28: no overflow
        scale = (mm.from_host(s, q, "cpu"), mm.from_host(s_con, q, "cpu"))
    tl, tx = torch.from_numpy(limbs), mm.from_host(x, q, "cpu")
    before = trace.LAUNCHES.copy()
    for fn in (mxu.limb_matmul_plain, mxu.limb_matmul):
        got = fn(tl, tx, q, contract, scale)
        assert got.dtype == torch.int32 and got.shape == tx.shape
        np.testing.assert_array_equal(mm.to_host(got), want)
    assert trace.LAUNCHES == before  # the CPU route launches nothing


def test_limb_matmul_checks():
    """q >= 2^28, wrong dtypes, shapes and contracts raise; a tensor on
    another device than the CPU or a CUDA card raises, never falls back."""
    limbs = torch.zeros((4, 8, 8), dtype=torch.int8)
    x = torch.zeros((2, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="supports q"):
        mxu.limb_matmul(limbs, x, 1 << 28 | 1, "left")
    with pytest.raises(ValueError, match="contract"):
        mxu.limb_matmul(limbs, x, 97, "middle")
    with pytest.raises(TypeError):
        mxu.limb_matmul(limbs, x.to(torch.int64), 97, "left")
    with pytest.raises(ValueError):
        mxu.limb_matmul(limbs, x, 97, "right")
    with pytest.raises(ValueError, match="scale"):
        mxu.limb_matmul(limbs, x, 97, "left", (x[0, :4], x[0, :4]))
    with pytest.raises(ValueError, match="unsupported device"):
        mxu.limb_matmul(limbs.to("meta"), x.to("meta"), 97, "left")


@pytest.mark.parametrize("kind,i", CASES)
def test_fwd_inv_equal_jax(jax_transforms, kind, i):
    """fwd_ntt / inv_ntt through 'mxu' equal to JAX's (strict, lazy too:
    the output is always strict), the forward equal to the port's
    'sixstep', the round trip exact; as tensors and as numpy."""
    jp, a, jf, jb, b = jax_transforms[kind, i]
    p = from_fields(jp)
    f = api.fwd_ntt(a, p, "mxu", device="cpu")
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(api.fwd_ntt(a, p, "mxu", lazy=True, device="cpu"), jf)
    np.testing.assert_array_equal(f, api.fwd_ntt(a, p, "sixstep", device="cpu"))
    np.testing.assert_array_equal(api.inv_ntt(b, p, "mxu", device="cpu"), jb)
    np.testing.assert_array_equal(api.inv_ntt(f, p, "mxu", device="cpu"), a)
    t = mm.from_host(a, p.q, "cpu")
    np.testing.assert_array_equal(mm.to_host(api.fwd_ntt(t, p, "mxu")), jf)


@pytest.mark.parametrize("kind,i", [("gen", 5), ("fixture", 1)])
def test_negacyclic_mul_equal_jax(kind, i):
    jp = jp_of(kind, i)
    a, b = rand(jp.q, (2, jp.n), 70), rand(jp.q, (2, jp.n), 71)
    np.testing.assert_array_equal(
        api.negacyclic_mul(a, b, from_fields(jp), variant="mxu", device="cpu"),
        jax_api.negacyclic_mul(a, b, jp, variant="mxu"))


def test_q_guard():
    """A q of 2^28 or more raises in the port as in the JAX package; 'auto'
    never picks mxu."""
    jp = JNttParams.generate(29, 6)
    a = rand(jp.q, (1, jp.n), 1)
    with pytest.raises(ValueError, match="supports q"):
        api.fwd_ntt(a, from_fields(jp), "mxu", device="cpu")
    with pytest.raises(ValueError, match="supports q"):
        api.inv_ntt(a, from_fields(jp), "mxu", device="cpu")
    with pytest.raises(ValueError, match="supports q"):
        jax_api.fwd_ntt(a, jp, variant="mxu")
    with pytest.raises(ValueError):
        ttw.mxu_tables(jp.w, jp.q, jp.n)
    assert api.variants()["mxu"].max_q_bits == jax_api.variants()["mxu"].max_q_bits == 28
    for m in (1, 8, 14, 20):
        assert api._pick(get_plan(from_fields(JNttParams.generate(28, m))), "auto").name != "mxu"
