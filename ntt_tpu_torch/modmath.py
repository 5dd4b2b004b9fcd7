"""Plain PyTorch modular arithmetic on int64 / int32 tensors.

The counterpart of ``ntt_tpu/modmath.py``.  A coefficient is one tensor
element holding an unsigned bit pattern in a signed dtype:

  * q < 2^30 (the word-32 path): ``torch.int32`` holding uint32 patterns,
    with word-32 Shoup constants;
  * q < 2^62 (the word-64 path): ``torch.int64`` holding uint64 patterns,
    with word-64 Shoup constants.

torch has no usable unsigned 64-bit arithmetic on the CPU, so the
unsigned operations are built from signed ones: add, subtract and
multiply wrap in two's complement exactly as the unsigned operations do;
a logical right shift is an arithmetic shift followed by a mask; an
unsigned compare flips the sign bit of both operands first.  The compare
matters: lazy values reach 4q, and 4q > 2^63 for q > 2^61 (the 62-bit
headline modulus), where a signed ``<`` is wrong.

Every function mirrors its JAX namesake bit for bit, lazy
representatives included; ``csrc/modarith.cuh`` is the device form of
the same arithmetic.  Constants are Python ints in [0, 2^word).
"""

from __future__ import annotations

import numpy as np
import torch

U32_PATH_MAX_Q_BITS = 30  # Shoup at word 32 needs t < 4q <= 2^32
MASK32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)
_SIGN32 = -(1 << 31)


def uses_u32(q: int) -> bool:
    """The width rule of the JAX plan (``NttPlan.supports_u32_radix2``)."""
    return q < (1 << U32_PATH_MAX_Q_BITS)


def dtype_for(q: int) -> torch.dtype:
    return torch.int32 if uses_u32(q) else torch.int64


def s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >> 63 else c


def s32(c: int) -> int:
    """An unsigned 32-bit constant as the int32 with the same bits."""
    c &= MASK32
    return c - (1 << 32) if c >> 31 else c


# ---------------------------------------------------------------------------
# Host <-> device representation
# ---------------------------------------------------------------------------


def from_host(a, q: int, device) -> torch.Tensor:
    """numpy uint64 values -> the device rep of the width that q selects.

    Raises if ``device`` is a CUDA device and no card is present: nothing
    here picks the CPU in its place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if uses_u32(q):
        host = a.astype(np.uint32).view(np.int32)
    else:
        host = a.view(np.int64)
    return torch.from_numpy(host.copy()).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Device rep -> numpy uint64."""
    h = t.detach().cpu().contiguous().numpy()
    if h.dtype == np.int32:
        return h.view(np.uint32).astype(np.uint64)
    if h.dtype == np.int64:
        return h.view(np.uint64).copy()
    raise TypeError(f"expected an int32 or int64 tensor, got {t.dtype}")


# ---------------------------------------------------------------------------
# word-64 primitives on int64
# ---------------------------------------------------------------------------


def shr64(x, k: int):
    """Logical right shift of a uint64 pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult64(a, b_const: int):
    """Unsigned a < b for an int64 tensor a and a constant b."""
    return (a ^ _SIGN64) < ((b_const & ((1 << 64) - 1)) - (1 << 63))


def _halves64(x):
    if isinstance(x, int):
        return x & MASK32, x >> 32
    return x & MASK32, shr64(x, 32)


def mulhi64(a, b):
    """High 64 bits of the 128-bit product of two uint64 patterns (either
    may be a constant), from 32-bit halves (refmodel.mulhi64)."""
    a0, a1 = _halves64(a)
    b0, b1 = _halves64(b)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = shr64(p00, 32) + (p01 & MASK32) + (p10 & MASK32)
    return a1 * b1 + shr64(p01, 32) + shr64(p10, 32) + shr64(mid, 32)


def cond_sub64(v, kq: int):
    """v if v < kq else v - kq (unsigned)."""
    return torch.where(ult64(v, kq), v, v - s64(kq))


def reduce_2q_to_q(v, q: int):
    return cond_sub64(v, q)


def reduce_4q_to_2q(v, q: int):
    return cond_sub64(v, 2 * q)


def reduce_4q_to_q(v, q: int):
    return reduce_2q_to_q(reduce_4q_to_2q(v, q), q)


def reduce_8q_to_4q(v, q: int):
    return cond_sub64(v, 4 * q)


def reduce_8q_to_2q(v, q: int):
    return reduce_4q_to_2q(reduce_8q_to_4q(v, q), q)


def reduce_8q_to_q(v, q: int):
    return reduce_2q_to_q(reduce_8q_to_2q(v, q), q)


def shoup_mul_q2(w, w_con, t, q: int):
    """(w*t - hi64(w_con*t)*q) mod 2^64, in [0, 2q) (the default path of
    ``ntt_tpu.modmath.shoup_mul_q2``)."""
    w = s64(w) if isinstance(w, int) else w
    return w * t - mulhi64(w_con, t) * s64(q)


def shoup_mul_q(w, w_con, t, q: int):
    return reduce_2q_to_q(shoup_mul_q2(w, w_con, t, q), q)


# ---------------------------------------------------------------------------
# word-32 primitives on int32
# ---------------------------------------------------------------------------


def _u32_as_i64(x):
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def mulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 patterns."""
    p = _u32_as_i64(a) * _u32_as_i64(b)
    return shr64(p, 32).to(torch.int32)


def ult32(a, b_const: int):
    return (a ^ _SIGN32) < ((b_const & MASK32) - (1 << 31))


def cond_sub32(v, kq: int):
    return torch.where(ult32(v, kq), v, v - s32(kq))


def reduce32(v, q: int, from_factor: int):
    """Reduce v < from_factor*q down to [0, q) by conditional subtracts."""
    f = from_factor
    while f > 1:
        f >>= 1
        v = cond_sub32(v, f * q)
    return v


def barrett_reduce32(v, q: int):
    """Any uint32 value to [0, q), q < 2^31 (Barrett with mu = 2^32 // q,
    then two conditional subtracts)."""
    mu = (1 << 32) // q
    r = v - mulhi32(mu, v) * s32(q)
    return cond_sub32(cond_sub32(r, 2 * q), q)


def shoup_mul32_q2(w, w_con, t, q: int):
    """Word-32 Shoup multiply; result < 2q for t < 2^32."""
    w = s32(w) if isinstance(w, int) else w
    return w * t - mulhi32(w_con, t) * s32(q)


# ---------------------------------------------------------------------------
# variable x variable products (pointwise, strict output)
# ---------------------------------------------------------------------------


def mul_mod_q32(a, b, q: int):
    """(a * b) mod q for int32 reps a, b < q < 2^30; strict output.  The
    64-bit product hi*2^32 + lo: hi folds through the constant 2^32 mod q
    (Shoup), lo through Barrett."""
    p = _u32_as_i64(a) * _u32_as_i64(b)  # < 2^60
    lo = (p & MASK32).to(torch.int32)
    hi = (p >> 32).to(torch.int32)
    c32 = (1 << 32) % q
    c32_con = (c32 << 32) // q
    t = shoup_mul32_q2(c32, c32_con, hi, q)  # < 2q
    r = t + barrett_reduce32(lo, q)  # < 3q < 2^32
    return cond_sub32(cond_sub32(r, 2 * q), q)


def mul_mod_q(a, b, q: int):
    """(a * b) mod q for int64 reps a, b < q < 2^62; strict output.  The
    128-bit product p3:p2:p1:p0 (32-bit limbs) folds as
    p3*(2^96 mod q) + p2*(2^64 mod q) + p1*(2^32 mod q) + p0 with
    Shoup-by-constant multiplies, each < 2q, and lazy reductions between."""
    lo = a * b
    hi = mulhi64(a, b)
    limbs = {0: lo & MASK32, 1: shr64(lo, 32), 2: hi & MASK32, 3: shr64(hi, 32)}
    folds = []
    for k in (3, 2, 1):
        c = (1 << (32 * k)) % q
        folds.append(shoup_mul_q2(c, (c << 64) // q, limbs[k], q))
    acc = reduce_4q_to_2q(folds[0] + folds[1], q)
    acc = reduce_4q_to_2q(acc + folds[2], q)
    p0 = limbs[0]
    if q < (1 << 31):
        mu = (1 << 32) // q
        r = p0 - shr64(p0 * mu, 32) * q  # exact, < 3q
        p0 = reduce_2q_to_q(reduce_4q_to_2q(r, q), q)
    elif q < (1 << 32):
        p0 = reduce_2q_to_q(p0, q)
    acc = cond_sub64(acc + p0, 2 * q)  # acc + p0 < 3q
    return reduce_2q_to_q(acc, q)
