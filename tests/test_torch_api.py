"""The port's public API (ntt_tpu_torch.api) on the CPU: against the JAX
package's api and ntt_tpu.refmodel, plus the port's own rules -- no import
of jax or of ntt_tpu, no silent CPU run for device="cuda", no kernel launch
from the CPU route, and 'auto' = pallas-fused within one block's shared
memory, the two-pass sixstep beyond.  The port takes its own NttParams:
the JAX package's come in through params.from_fields."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import refmodel as rm
from ntt_tpu.params import FIXTURES as JFIXTURES
from ntt_tpu.params import NttParams as JNttParams
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import api
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import fused, pointwise, sixstep, twopass
from ntt_tpu_torch.params import FIXTURES, NttParams, bench_params, from_fields
from ntt_tpu_torch.plan import TABLE_NAMES, NttPlan, get_plan

from conftest import fixture_id

REPO = pathlib.Path(__file__).resolve().parent.parent
# word 64 at m = 5: a Pallas call in interpret mode costs seconds on the CPU,
# more the larger m
ONE_OF_EACH_WIDTH = [FIXTURES[0], NttParams.generate(62, 5)]
JAX_ONE_OF_EACH_WIDTH = [JFIXTURES[0], JNttParams.generate(62, 5)]


def rand(p, shape, seed):
    return np.random.default_rng(seed).integers(0, p.q, size=shape, dtype=np.uint64)


def zero_launch_counts():
    for counts in (fused.LAUNCHES, pointwise.LAUNCHES, twopass.LAUNCHES):
        for k in counts:
            counts[k] = 0


def test_variant_registry():
    assert set(api.variants()) == {"pallas-fused", "sixstep", "sixstep-unordered", "sixstep-rec"}
    assert all(v.inv is not None for v in api.variants().values())
    with pytest.raises(KeyError, match="unknown NTT variant"):
        api.get_variant("radix2")


@pytest.mark.parametrize("jp", JAX_ONE_OF_EACH_WIDTH, ids=fixture_id)
def test_negacyclic_mul_matches_jax_api(jp):
    """The JAX product composed through the same variant (pallas-fused,
    interpret mode) as the port's."""
    a, b = rand(jp, (2, jp.n), 20), rand(jp, (2, jp.n), 21)
    np.testing.assert_array_equal(api.negacyclic_mul(a, b, from_fields(jp), device="cpu"),
                                  jax_api.negacyclic_mul(a, b, jp, variant="pallas-fused"))


@pytest.fixture(scope="module")
def jax_product():
    """One JAX product at m = 8, word 32 (its default, fused=True), shared by
    the cases of test_negacyclic_mul_fused_keyword: the output is strict, so
    the JAX package gives the same bits for every variant and keyword."""
    jp = JFIXTURES[0]
    a, b = rand(jp, (2, jp.n), 26), rand(jp, (2, jp.n), 27)
    return jp, a, b, jax_api.negacyclic_mul(a, b, jp, fused=True)


@pytest.mark.parametrize("variant,fused", [("auto", True), ("auto", False), ("sixstep", True),
                                           ("sixstep", False), ("pallas-fused", True)])
def test_negacyclic_mul_fused_keyword(jax_product, monkeypatch, variant, fused):
    """The reference's signature, negacyclic_mul(a, b, p, variant, fused):
    equal to the JAX product bit for bit; through 'sixstep' with fused the
    forwards keep the transposed layout, and every other call composes the
    variant's standard-order forwards (here 'auto' is pallas-fused)."""
    jp, a, b, want = jax_product
    kept = []
    fwd_rows = twopass.fwd_rows

    def spy(x, plan, n1_log, strict=True, keep_transposed=False):
        kept.append(keep_transposed)
        return fwd_rows(x, plan, n1_log, strict, keep_transposed)

    monkeypatch.setattr(twopass, "fwd_rows", spy)
    got = api.negacyclic_mul(a, b, from_fields(jp), variant, fused, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert kept == ([fused, fused] if variant == "sixstep" else [])


@pytest.mark.parametrize("jp", JAX_ONE_OF_EACH_WIDTH, ids=fixture_id)
def test_pointwise_mul_matches_jax_api(jp):
    a, b = rand(jp, (2, jp.n), 22), rand(jp, (2, jp.n), 23)
    a[0, 0] = b[0, 0] = jp.q - 1
    np.testing.assert_array_equal(api.pointwise_mul(a, b, from_fields(jp), device="cpu"),
                                  jax_api.pointwise_mul(a, b, jp))


def test_headline_params_roundtrip_and_product_vs_refmodel():
    """bench_params(14, 62): N = 2^14, q = 2^62 - 2^16 + 1, batch 1."""
    p = bench_params(14, 62)
    plan = get_plan(p)
    a, b = rand(p, (1, p.n), 24), rand(p, (1, p.n), 25)
    fa = api.fwd_ntt(a, p, device="cpu")
    np.testing.assert_array_equal(fa, rm.fwd_ntt_harvey(a, p.q, plan.w, plan.w_con))
    np.testing.assert_array_equal(api.inv_ntt(fa, p, device="cpu"), a)
    fb = rm.fwd_ntt_harvey(b, p.q, plan.w, plan.w_con)
    prod = np.array([int(x) * int(y) % p.q for x, y in zip(fa[0], fb[0])], dtype=np.uint64)
    want = rm.inv_ntt_harvey(prod[None], p.q, p.n_inv, plan.n_inv_con, plan.w_inv,
                             plan.w_inv_con)
    np.testing.assert_array_equal(api.negacyclic_mul(a, b, p, device="cpu"), want)


@pytest.mark.parametrize("jp", JAX_ONE_OF_EACH_WIDTH, ids=fixture_id)
def test_plan_from_jax_tables_equals_own_plan(jp):
    jplan = jax_get_plan(jp)
    p = from_fields(jp)
    theirs = NttPlan.from_numpy(p, {k: getattr(jplan, k) for k in TABLE_NAMES})
    ours = NttPlan(p)
    for k, v in ours.host_tables().items():
        np.testing.assert_array_equal(theirs.host_tables()[k], v, err_msg=k)
    assert theirs.inv_consts == ours.inv_consts
    a = mm.from_host(rand(p, (2, p.n), 26), p.q, "cpu")
    f = fused.fwd_fused(a, theirs, strict=False)
    assert torch.equal(f, fused.fwd_fused(a, ours, strict=False))
    assert torch.equal(fused.inv_fused(f, theirs), fused.inv_fused(f, ours))
    with pytest.raises(KeyError):
        NttPlan.from_numpy(p, {"w": jplan.w})


def test_import_leaves_jax_out():
    """Importing every module of the port and chip_smoke loads neither jax
    nor anything of ntt_tpu."""
    modules = sorted(
        "ntt_tpu_torch" + "".join("." + part for part in f.relative_to(
            REPO / "ntt_tpu_torch").with_suffix("").parts if part != "__init__")
        for f in (REPO / "ntt_tpu_torch").rglob("*.py"))
    assert "ntt_tpu_torch.kernels.twopass" in modules
    code = (
        f"import sys, importlib; [importlib.import_module(m) for m in {modules!r}]; "
        "import chip_smoke; "
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'ntt_tpu')); "
        "assert not bad, bad; print('jax-free')"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "jax-free"


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    p = FIXTURES[0]
    a = rand(p, (2, p.n), 27)

    def cpu_route(*args, **kwargs):
        raise AssertionError("a device='cuda' call ran the CPU route")

    if torch.cuda.is_available():
        np.testing.assert_array_equal(api.fwd_ntt(a, p), api.fwd_ntt(a, p, device="cpu"))
        return
    monkeypatch.setattr(sixstep, "fwd_sixstep", cpu_route)
    with pytest.raises(RuntimeError, match="is_available"):
        api.fwd_ntt(a, p)
    with pytest.raises(RuntimeError, match="is_available"):
        api.negacyclic_mul(a, a, p)


def test_cpu_route_launches_no_kernel():
    zero_launch_counts()
    for p in ONE_OF_EACH_WIDTH:
        a = rand(p, (2, p.n), 28)
        f = api.fwd_ntt(a, p, device="cpu")
        api.fwd_ntt(a, p, lazy=True, device="cpu")
        api.inv_ntt(f, p, device="cpu")
        api.pointwise_mul(a, a, p, device="cpu")
        api.negacyclic_mul(a, a, p, device="cpu")
        for variant in ("sixstep", "sixstep-unordered"):
            api.inv_ntt(api.fwd_ntt(a, p, variant, device="cpu"), p, variant, device="cpu")
        api.negacyclic_mul(a, a, p, variant="sixstep", device="cpu")
    assert set(fused.LAUNCHES.values()) == {0}
    assert set(pointwise.LAUNCHES.values()) == {0}
    assert set(twopass.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("p", [FIXTURES[15], NttParams.generate(29, 16)], ids=fixture_id)
def test_auto_stops_beyond_one_block(p):
    """m = 15 at word 64 and m = 16 at word 32 do not fit one block's
    shared memory: 'auto' stops using pallas-fused there and takes the
    two-pass six-step, and pallas-fused itself refuses, naming it."""
    plan = get_plan(p)
    below = get_plan(NttParams.generate(29 if plan.word == 32 else 62, p.m - 1))
    assert api._pick(below, "auto").name == "pallas-fused"
    assert api._pick(plan, "auto").name == "sixstep"
    a = rand(p, (1, p.n), 32)
    f = api.fwd_ntt(a, p, device="cpu")
    np.testing.assert_array_equal(f, api.fwd_ntt(a, p, variant="sixstep", device="cpu"))
    np.testing.assert_array_equal(api.inv_ntt(f, p, device="cpu"), a)
    with pytest.raises(ValueError, match="sixstep"):
        api.fwd_ntt(a, p, variant="pallas-fused", device="cpu")
    with pytest.raises(ValueError, match="sixstep"):
        api.inv_ntt(a, p, variant="pallas-fused", device="cpu")


@pytest.mark.parametrize("p", ONE_OF_EACH_WIDTH, ids=fixture_id)
def test_tensors_stay_tensors(p):
    a = rand(p, (3, p.n), 29)
    t = mm.from_host(a, p.q, "cpu")
    out = api.fwd_ntt(t, p, lazy=True)
    assert isinstance(out, torch.Tensor) and out.dtype == t.dtype
    np.testing.assert_array_equal(mm.to_host(out), api.fwd_ntt(a, p, lazy=True, device="cpu"))
    with pytest.raises(TypeError):
        api.fwd_ntt(t.to(torch.int16), p)
    with pytest.raises(TypeError):
        api.negacyclic_mul(t, a, p)


def test_fwd_ntt_dbl():
    p = FIXTURES[2]
    a, b = rand(p, (p.n,), 30), rand(p, (p.n,), 31)
    x, y = api.fwd_ntt_dbl(a, b, p, device="cpu")
    np.testing.assert_array_equal(x, api.fwd_ntt(a, p, device="cpu"))
    np.testing.assert_array_equal(y, api.fwd_ntt(b, p, device="cpu"))
