"""K11's order of sums, as integers: an int64 model of what each body of
``csrc/mxu.cu`` keeps in which register, checked against the register's
width at every step, at the worst case (every limb 127, the widest 28-bit
q) at every K from 2 to 4096, and against ``limb_matmul_plain`` on small
random tiles of both contracts.  No JAX call and no card.  Tolerance: none,
bit-exact.

The wgmma body (K >= ``mxu.WGMMA_MIN_K``) takes the contraction in chunks
of ``mxu.WGMMA_CHUNK``; in each it forms, in int32 tiles, E0 = R + D0 +
2^7 D1 (R the last chunk's carry), E2 = D2 + 2^7 D3, E4 = D4 + 2^7 D5 and
D6, adds the Shoup products of E2, E4 and D6 by 2^14, 2^28 and 2^42 mod q
onto E0 in a u32 residue and takes it by Barrett to the next carry in
[0, 2q).  The mma.sync body (smaller K) sums the seven
diagonals over the whole K in int32 and recombines them by JAX's
Shoup-Horner chain by 2^7 (acc < 2q + 2^28) and Barrett."""

import numpy as np
import pytest
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import mxu
from ntt_tpu_torch.params import FIXTURES, NttParams

LIMBS, BITS = 4, 7
INT32, U32 = 1 << 31, 1 << 32
# FIXTURES[8] (0xfff0001) and the port's widest 28-bit NTT prime at m24
QS = (FIXTURES[8].q, NttParams.generate(28, 24).q)
KS = tuple(1 << k for k in range(1, mxu.MAX_K_LOG + 1))  # 2 .. 4096
WORST_WORD = (1 << (LIMBS * BITS)) - 1  # 0x0fffffff: every limb 127


def shoup(w, t, q):
    """shoup_mul_q2 at word 32 (``modarith.cuh``), on ints below 2^32."""
    w_con = (w << 32) // q
    return (w * t - ((w_con * t) >> 32) * q) % U32


def barrett(t, q):
    return t - (((U32 // q) * t) >> 32) * q


def diagonals(mat_limbs, x_limbs, lo, hi):
    """D_d = sum over s + t = d of mat_s . x_t over k in [lo, hi), as ints."""
    dots = [[int(np.dot(mat_limbs[s, lo:hi], x_limbs[t, lo:hi])) for t in range(LIMBS)]
            for s in range(LIMBS)]
    return [sum(dots[s][d - s] for s in range(LIMBS) if 0 <= d - s < LIMBS)
            for d in range(2 * LIMBS - 1)]


def model_word(mat_limbs, x_limbs, q):
    """One output word of K11 in its body's order; asserts every bound."""
    k = mat_limbs.shape[-1]
    if mxu.body(k) == "wgmma":
        carry = 0
        for lo in range(0, k, mxu.WGMMA_CHUNK):
            diag = diagonals(mat_limbs, x_limbs, lo, lo + mxu.WGMMA_CHUNK)
            assert max(diag) < INT32  # each diagonal alone, in an int32 tile
            # E0, E2, E4: the upper diagonal shifted by 7, the lower summed
            # onto it (E0 onto the carry first), each step in the int32 tile
            pairs = [carry + (diag[1] << BITS), diag[3] << BITS, diag[5] << BITS]
            assert max(pairs) < INT32
            e0, e2, e4 = (pairs[0] + diag[0], pairs[1] + diag[2], pairs[2] + diag[4])
            assert max(e0, e2, e4) < INT32
            t = e0  # the u32 residue
            for d, e in ((2, e2), (6, diag[6]), (4, e4)):  # the kernel's order
                p = shoup(pow(2, BITS * d, q), e, q)
                assert p < 2 * q
                t += p
                assert t < U32
            carry = barrett(t, q)
            assert carry < 2 * q
        v = carry
    else:
        diag = diagonals(mat_limbs, x_limbs, 0, k)
        assert max(diag) < 1 << 28
        t = diag[-1]
        for d in range(2 * LIMBS - 3, -1, -1):
            t = shoup((1 << BITS) % q, t, q) + diag[d]
            assert t < 2 * q + (1 << 28) <= U32
        v = barrett(t, q)
        assert v < 2 * q
    return v - q if v >= q else v


def limbs_of(words):
    words = np.asarray(words, dtype=np.int64)
    return np.stack([(words >> (BITS * s)) & 127 for s in range(LIMBS)])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("q", QS, ids=hex)
def test_worst_case_word_fits_every_register(q, k):
    """Every limb 127 on both sides, at every K: each partial sum fits the
    register that holds it, and the word is the exact residue."""
    mat_limbs = np.full((LIMBS, k), 127, dtype=np.int64)
    x_limbs = limbs_of(np.full(k, WORST_WORD))
    assert (x_limbs == 127).all()
    assert model_word(mat_limbs, x_limbs, q) == k * WORST_WORD * WORST_WORD % q


def mulhi32(a, b):
    """floor(a * b / 2^32) of int64 tensors below 2^32, without overflow."""
    return (a >> 16) * b + (((a & 0xFFFF) * b) >> 16) >> 16


def model_tile(mat_limbs, x, q, contract, scale):
    """K11 on a whole tile, in int64 tensors, in its body's order; the
    bounds asserted as in ``model_word``."""
    k = mat_limbs.shape[-1]
    ml = mat_limbs.to(torch.int64)
    xw = x.to(torch.int64) & 0xFFFFFFF
    rows = xw.reshape(-1, k) if contract == "right" else xw.transpose(1, 2).reshape(-1, k)
    xl = [(rows >> (BITS * t)) & 127 for t in range(LIMBS)]

    def diag(d, lo, hi):
        return sum(xl[d - s][:, lo:hi] @ ml[s][:, lo:hi].T
                   for s in range(LIMBS) if 0 <= d - s < LIMBS)

    if mxu.body(k) == "wgmma":
        carry = torch.zeros(rows.shape[0], k, dtype=torch.int64)
        for lo in range(0, k, mxu.WGMMA_CHUNK):
            hi = lo + mxu.WGMMA_CHUNK
            dg = [diag(d, lo, hi) for d in range(2 * LIMBS - 1)]
            t = carry + (dg[1] << BITS) + dg[0]
            e2, e4 = (dg[3] << BITS) + dg[2], (dg[5] << BITS) + dg[4]
            assert max(int(v.max()) for v in (t, e2, e4, dg[6])) < INT32
            for d, acc in ((2, e2), (6, dg[6]), (4, e4)):
                w = pow(2, BITS * d, q)
                p = (w * acc - mulhi32(torch.full_like(acc, (w << 32) // q), acc) * q) % U32
                assert int(p.max()) < 2 * q
                t = t + p
                assert int(t.max()) < U32
            carry = t - mulhi32(torch.full_like(t, U32 // q), t) * q
            assert int(carry.max()) < 2 * q
        v = carry
    else:
        ds = [diag(d, 0, k) for d in range(2 * LIMBS - 1)]
        assert max(int(dd.max()) for dd in ds) < 1 << 28
        c128 = (1 << BITS) % q
        t = ds[-1]
        for d in range(2 * LIMBS - 3, -1, -1):
            con = torch.full_like(t, (c128 << 32) // q)
            t = (c128 * t - mulhi32(con, t) * q) % U32 + ds[d]
            assert int(t.max()) < 2 * q + (1 << 28)
        v = t - mulhi32(torch.full_like(t, U32 // q), t) * q
    v = torch.where(v >= q, v - q, v)
    if contract == "left":
        v = v.reshape(x.shape[0], x.shape[2], k).transpose(1, 2)
    v = v.reshape(x.shape)
    if scale is not None:
        s = scale[0].to(torch.int64) & 0xFFFFFFFF
        s_con = scale[1].to(torch.int64) & 0xFFFFFFFF
        v = (s * v - mulhi32(s_con.expand_as(v), v) * q) % U32
        v = torch.where(v >= q, v - q, v)
    return v.to(torch.int32)


@pytest.mark.parametrize("k", (4, 32, 128, 256))
@pytest.mark.parametrize("scaled", (False, True), ids=("plain", "scaled"))
@pytest.mark.parametrize("contract", mxu.CONTRACTS)
def test_model_equals_plain(contract, scaled, k):
    """The model of the kernel's order against limb_matmul_plain on random
    tiles: both bodies (K 128 and 256 the wgmma body, one and two chunks),
    both contracts, with and without the scale."""
    q = QS[0]
    rng = np.random.default_rng(k + 7 * scaled)
    free = 4
    shape = (2, k, free) if contract == "left" else (2, free, k)
    x = torch.from_numpy(rng.integers(0, 1 << 31, size=shape, dtype=np.int64)).to(torch.int32)
    mat = torch.from_numpy(rng.integers(0, 128, size=(LIMBS, k, k), dtype=np.int8))
    scale = None
    if scaled:
        tab_shape = (k, free) if contract == "left" else (free, k)
        s = torch.from_numpy(rng.integers(0, q, size=tab_shape, dtype=np.int64))
        scale = (s.to(torch.int32), ((s << 32) // q).to(torch.int32))
    want = mxu.limb_matmul_plain(mat, x, q, contract, scale)
    assert torch.equal(model_tile(mat, x, q, contract, scale), want)
    assert torch.equal(mm.cond_sub32(want, q), want)  # strict


@pytest.mark.parametrize("m", range(1, 25))
def test_body_by_m(m):
    """The body K11 picks at every m of the mxu split: left contracts over
    N1 = 2^(m // 2) (wgmma from m14), right over N2 (wgmma from m13)."""
    left, right = mxu.body(1 << m // 2), mxu.body(1 << (m - m // 2))
    assert left == ("wgmma" if m >= 14 else "mma.sync")
    assert right == ("wgmma" if m >= 13 else "mma.sync")
