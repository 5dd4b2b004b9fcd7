"""The port's serving handle api.DeviceNtt on the CPU: fwd, inv, pointwise
and negacyclic, lazy included, bit for bit against the JAX package's
api.DeviceNtt (jnp six-step) and the port's host API, with a forced int
tile, pad_to_tile and both tile modes (the pattern of
tests/test_polymul.py's handle tests), and the no-fallback rule of the
default device.  The JAX handles run once a width, at m = 6, through a
module-scoped fixture."""

import dataclasses

import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import params as jparams
from ntt_tpu_torch import api
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import twopass
from ntt_tpu_torch.params import NttParams, from_fields

BATCH = 8  # rows the JAX handles transform; the port also takes the first 7 and 3


def rand(q, shape, seed):
    return np.random.default_rng(seed).integers(0, q, size=shape, dtype=np.uint64)


@pytest.fixture(scope="module", params=[29, 51], ids=["q29", "q51"])
def jax_handle(request):
    """The JAX handle's outputs at m = 6 (word 32 for 29 bits, word 64 for
    51): forward strict and lazy, inverse, pointwise product of the
    forwards, and the product strict and through the lazy handle."""
    jp = jparams.NttParams.generate(request.param, 6)
    a, b = rand(jp.q, (BATCH, jp.n), 1), rand(jp.q, (BATCH, jp.n), 2)
    out = {}
    for lazy in (False, True):
        ctx = jax_api.DeviceNtt(jp, lazy=lazy)
        ra, rb = ctx.from_host(a), ctx.from_host(b)
        fa, fb = ctx.fwd(ra), ctx.fwd(rb)
        out["fwd", lazy] = ctx.to_host(fa)
        out["negacyclic", lazy] = ctx.to_host(ctx.negacyclic(ra, rb))
        if not lazy:
            out["inv"] = ctx.to_host(ctx.inv(fa))
            out["pointwise"] = ctx.to_host(ctx.pointwise(fa, fb))
    return from_fields(jp), a, b, out


TILINGS = [("auto", False, "unroll"), (None, False, "unroll"), (4, False, "unroll"),
           (4, False, "map"), (4, True, "unroll"), (4, True, "map")]


@pytest.mark.parametrize("lazy", [False, True], ids=["strict", "lazy"])
@pytest.mark.parametrize("tiling", TILINGS, ids=lambda t: f"{t[0]}-pad{int(t[1])}-{t[2]}")
def test_handle_equals_jax_handle(jax_handle, tiling, lazy):
    """At batch 8 (tiled by an int tile of 4), 7 (padded to 8 with
    pad_to_tile, else direct) and 3 (at most a tile: direct)."""
    p, a, b, want = jax_handle
    batch_tile, pad, mode = tiling
    ctx = api.DeviceNtt(p, lazy=lazy, batch_tile=batch_tile, pad_to_tile=pad, tile_mode=mode,
                        device="cpu")
    for rows in (BATCH, 7, 3):
        ta, tb = ctx.from_host(a[:rows]), ctx.from_host(b[:rows])
        fa = ctx.fwd(ta)
        assert fa.shape == ta.shape and fa.dtype == ta.dtype
        np.testing.assert_array_equal(ctx.to_host(fa), want["fwd", lazy][:rows])
        np.testing.assert_array_equal(ctx.to_host(ctx.negacyclic(ta, tb)),
                                      want["negacyclic", lazy][:rows])
        if not lazy:
            np.testing.assert_array_equal(ctx.to_host(ctx.inv(fa)), want["inv"][:rows])
            np.testing.assert_array_equal(
                ctx.to_host(ctx.pointwise(fa, ctx.fwd(tb))), want["pointwise"][:rows])
    np.testing.assert_array_equal(want["inv"], a)
    np.testing.assert_array_equal(want["negacyclic", False],
                                  api.negacyclic_mul(a, b, p, device="cpu"))


def _spy_variant(ctx, calls):
    """Record the rows of every forward and inverse the handle runs."""
    v = ctx._variant

    def fwd(plan, x, lazy):
        calls.append(("fwd", x.shape[0]))
        return v.fwd(plan, x, lazy)

    def inv(plan, x):
        calls.append(("inv", x.shape[0]))
        return v.inv(plan, x)

    ctx._variant = dataclasses.replace(v, fwd=fwd, inv=inv)


@pytest.mark.parametrize("rows,pad,want", [
    (8, False, [("fwd", 4), ("fwd", 4), ("inv", 4)] * 2),
    (7, True, [("fwd", 4), ("fwd", 4), ("inv", 4)] * 2),
    (7, False, [("fwd", 7), ("fwd", 7), ("inv", 7)]),
    (3, True, [("fwd", 3), ("fwd", 3), ("inv", 3)]),
])
def test_negacyclic_chains_a_tile_at_a_time(rows, pad, want):
    """An int tile runs forwards, product and inverse a tile at a time;
    pad_to_tile pads once and slices once; otherwise one direct call."""
    p = NttParams.generate(29, 6)
    ctx = api.DeviceNtt(p, batch_tile=4, pad_to_tile=pad, device="cpu")
    calls = []
    _spy_variant(ctx, calls)
    a, b = rand(p.q, (rows, p.n), 3), rand(p.q, (rows, p.n), 4)
    got = ctx.negacyclic(ctx.from_host(a), ctx.from_host(b))
    assert calls == want and got.shape == (rows, p.n)
    np.testing.assert_array_equal(ctx.to_host(got), api.negacyclic_mul(a, b, p, device="cpu"))


@pytest.mark.parametrize("p", [NttParams.generate(62, 15), NttParams.generate(29, 16)],
                         ids=["q62-m15", "q29-m16"])
def test_handle_beyond_one_block_keeps_the_transposed_layout(p, monkeypatch):
    """Beyond one block the handle runs the two-pass six-step: its lazy
    forward gives the six-step's representatives, and its product keeps
    the transposed layout between the forwards and the inverse."""
    a, b = rand(p.q, (2, p.n), 5), rand(p.q, (2, p.n), 6)
    ctx = api.DeviceNtt(p, lazy=True, device="cpu")
    assert ctx._variant.name == "sixstep"
    np.testing.assert_array_equal(ctx.to_host(ctx.fwd(ctx.from_host(a))),
                                  api.fwd_ntt(a, p, variant="sixstep", lazy=True, device="cpu"))
    layouts, fwd_rows = [], twopass.fwd_rows

    def spy(*args, **kwargs):
        layouts.append(kwargs.get("keep_transposed", False))
        return fwd_rows(*args, **kwargs)

    monkeypatch.setattr(twopass, "fwd_rows", spy)
    got = ctx.to_host(ctx.negacyclic(ctx.from_host(a), ctx.from_host(b)))
    assert layouts == [True, True]
    np.testing.assert_array_equal(got, api.negacyclic_mul(a, b, p, device="cpu"))


def test_handle_takes_its_own_tensors_only():
    p = NttParams.generate(29, 6)
    ctx = api.DeviceNtt(p, device="cpu")
    a = rand(p.q, (2, p.n), 7)
    with pytest.raises(TypeError, match="tensors"):
        ctx.fwd(a)
    with pytest.raises(TypeError):
        ctx.fwd(mm.from_host(a, p.q, "cpu").to(torch.int64))
    with pytest.raises(ValueError):
        api.DeviceNtt(p, batch_tile=0, device="cpu")
    with pytest.raises(ValueError):
        api.DeviceNtt(p, tile_mode="scan", device="cpu")


def test_handle_default_device_is_cuda_and_never_falls_back():
    """DeviceNtt(p) puts its tables on the card; without one it raises and
    runs nothing on the CPU in its place."""
    p = NttParams.generate(29, 6)
    if torch.cuda.is_available():
        ctx = api.DeviceNtt(p)
        assert ctx.tables[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        api.DeviceNtt(p)
