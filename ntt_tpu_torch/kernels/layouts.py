"""Output-order descriptors of the forward transforms.

The counterpart of ``ntt_tpu/kernels/layouts.py`` (``Layout``,
``standard``, ``radix4_vec_unordered``, ``transposed``).  A variant may return its forward output in
any documented layout, named by a ``Layout`` that carries the permutation
back to the standard order (bit-reversed, as every reference forward).
Applying one is a gather on the host or the device, never part of the hot
path: a product that chains forward -> pointwise -> inverse never needs the
standard order at all.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Layout:
    """A named output ordering of length-n transforms.  ``perm`` maps the
    standard index to the position in the output:
    ``standard[i] == out[perm[i]]``."""

    name: str
    n: int
    perm: np.ndarray

    def fix(self, a):
        """``a`` (..., n) re-ordered to the standard order (numpy array or
        tensor)."""
        return a[..., self.perm]

    def unfix(self, a):
        """The inverse of ``fix``: ``a`` in the standard order re-ordered to
        this layout."""
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.n)
        return a[..., inv]


def standard(n: int) -> Layout:
    """The identity layout: the reference's bit-reversed output order."""
    return Layout("standard", n, np.arange(n))


def radix4_vec_unordered(n: int) -> Layout:
    """The 'radix4-vec-unordered' forward's order: its last radix-4 stage
    (t == 1, groups of 4 words) takes the groups of each block of 8 in
    LANE_PERM order and stores them in place, so standard group 8b + j sits
    at slot argsort(LANE_PERM)[j] of block b."""
    from ntt_tpu_torch.twiddles import LANE_PERM

    slot_of = np.argsort(LANE_PERM)
    r = np.arange(n)
    g, c = r >> 2, r & 3
    return Layout("radix4-vec-unordered", n, 4 * (((g >> 3) << 3) + slot_of[g & 7]) + c)


def transposed(n: int, n1_log: int) -> Layout:
    """The six-step keep_transposed layout: the output flattened as (N2, N1)
    instead of (N1, N2), so standard[c1*N2 + c2] == out[c2*N1 + c1]."""
    logn = n.bit_length() - 1
    n1, n2 = 1 << n1_log, 1 << (logn - n1_log)
    c1, c2 = np.divmod(np.arange(n), n2)
    return Layout(f"transposed[n1=2^{n1_log}]", n, c2 * n1 + c1)
