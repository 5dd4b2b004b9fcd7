"""The 'mxu' variant: the four-step NTT as two int8-limb matrix products mod
q, on CUDA kernel K11 ``limb_matmul``.

The counterpart of ``ntt_tpu/kernels/mxu.py``.  For N = N1 * N2 at the
balanced split (``twiddles.mxu_split``: N1 = 2^(m // 2)), the forward on
``a`` viewed (b, N1, N2) is

  1. col = (M1 @ a) mod q, the ``left`` contract;
  2. z = col * T mod q, strict (fused into step 1's launch here);
  3. out = (z @ W2^T) mod q, the ``right`` contract;

and the inverse runs ``right`` with W2i, the scale by S (N^-1 folded in,
fused into that launch) and ``left`` with M1i.  Output in the standard
bit-reversed order, always strict (``lazy`` changes nothing, as in JAX);
q < 2^28.  A transform is two K11 launches.

Each ``(mat @ x) mod q`` splits the matrix (on the host, ``plan.mxu``) and
x (in the kernel, as it is staged) into four 7-bit limbs, takes the 16
limb products with exact integer sums, adds them into the 7 diagonals
d = s + t, and recombines sum_d D_d 2^(7d) mod q with a Shoup-Horner chain
by 2^7 and a Barrett reduction (``_matmul_mod_q`` and ``_horner_mod_q``,
mxu.py:107-152).  K11 (``csrc/mxu.cu``) runs the limb products on the
int8 tensor cores, in one of two bodies picked by K alone (``body``): from
K = 128 on warpgroup ``wgmma`` with TMA-fed shared-memory stages, every
128 k (``WGMMA_CHUNK``) the diagonals paired as E0 = carry + D0 + 2^7 D1,
E2 = D2 + 2^7 D3, E4 = D4 + 2^7 D5 in int32 and folded into the residue by
Shoup products by 2^14, 2^28 and 2^42 mod q (with D6); below K = 128 on
``mma.sync`` with the seven diagonals over the whole K and JAX's Horner
chain.  Every output is the exact residue, so both orders give these bits
(``tests/test_torch_mxu_order.py`` holds each order's partial sums to their
registers).  The plain version
``limb_matmul_plain`` takes the limb products as
float64 matrix products, exact because every partial sum is an integer
below 2^31 < 2^53 (PyTorch has no int64 matrix product on CUDA, and
float32 or TF32 lose bits beyond 2^24).

The wrapper runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; it never falls back from one to the other.
Each call is a kernel span (``trace.py``); ``native.launch`` counts each
launch in ``trace.LAUNCHES`` (``limb_matmul_<contract>``, with
``_scaled`` where a scale is fused).
"""

from __future__ import annotations

import numpy as np
import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native, trace
from ntt_tpu_torch import twiddles as tw
from ntt_tpu_torch.plan import NttPlan

LIMBS, LIMB_BITS = tw.MXU_LIMBS, tw.MXU_LIMB_BITS
MAX_Q_BITS = tw.MXU_MAX_Q_BITS
MAX_K_LOG = 12  # K11 takes K up to 4096 (m24): a diagonal stays below 2^28
WGMMA_MIN_K = 128  # K11's wgmma body serves K >= 128 (csrc/mxu.cu wg::kMinKLog)
WGMMA_CHUNK = 128  # ... and folds its diagonals every 128 k (wg::kChunk)
CONTRACTS = ("left", "right")


def _limbs_of_values(x: torch.Tensor) -> list[torch.Tensor]:
    """The four 7-bit limbs (bits 0-27) of int32 words, as int32 tensors."""
    mask = (1 << LIMB_BITS) - 1
    return [(x >> (LIMB_BITS * s)) & mask for s in range(LIMBS)]


def _horner_mod_q(diags: list[torch.Tensor], q: int) -> torch.Tensor:
    """sum_d diags[d] 2^(7d) mod q for int32 diagonals below 2^28: a
    Shoup-Horner chain by 2^7 mod q (acc < 2q + 2^28 < 2^32), then a
    Barrett reduction to [0, q)."""
    c128 = (1 << LIMB_BITS) % q
    c128_con = (c128 << 32) // q
    acc = diags[-1]
    for d in range(len(diags) - 2, -1, -1):
        acc = mm.shoup_mul32_q2(c128, c128_con, acc, q) + diags[d]
    return mm.barrett_reduce32(acc, q)


def body(k: int) -> str:
    """The body K11 runs at contraction depth K, by K alone (csrc/mxu.cu's
    ``launch_limb_matmul``): ``"wgmma"`` from ``WGMMA_MIN_K``, else
    ``"mma.sync"``.  ``left`` contracts over N1 = 2^(m // 2), so it takes
    wgmma from m14; ``right`` over N2, from m13."""
    return "wgmma" if k >= WGMMA_MIN_K else "mma.sync"


def wgmma_smem_bytes(k: int) -> int:
    """Dynamic shared memory a CTA of K11's wgmma body takes at K (csrc/mxu.cu
    ``wg::launch``): 64 KB a matrix stage (every chunk of 128 k while K <=
    256, else a ring of two), a 32 KB x buffer for each of its two pairs of
    warpgroups, 1 KB of alignment and the barriers."""
    return min(k // WGMMA_CHUNK, 2) * (1 << 16) + 2 * (1 << 15) + 1024 + 2 * 12


def _check(mat_limbs: torch.Tensor, x: torch.Tensor, q: int, contract: str, scale):
    """The shapes of one call: (K, k_log, f_log)."""
    if contract not in CONTRACTS:
        raise ValueError(f"contract must be 'left' or 'right', got {contract!r}")
    if q >= 1 << MAX_Q_BITS:
        raise ValueError(f"limb_matmul supports q < 2^{MAX_Q_BITS}, got a "
                         f"{q.bit_length()}-bit q")
    if mat_limbs.dtype != torch.int8 or x.dtype != torch.int32:
        raise TypeError(f"limb_matmul takes int8 limbs and int32 words, got {mat_limbs.dtype} "
                        f"and {x.dtype}")
    k = mat_limbs.shape[-1]
    if mat_limbs.shape != (LIMBS, k, k) or k & (k - 1):
        raise ValueError(f"the matrix limbs must be ({LIMBS}, K, K), K a power of two, got "
                         f"{tuple(mat_limbs.shape)}")
    if contract == "left":
        if x.dim() != 3 or x.shape[1] != k:
            raise ValueError(f"left takes x of shape (batch, {k}, F), got {tuple(x.shape)}")
        rows, cols = x.shape[1], x.shape[2]
    else:
        if x.dim() < 2 or x.shape[-1] != k:
            raise ValueError(f"right takes x of shape (..., N1, {k}), got {tuple(x.shape)}")
        rows, cols = x.shape[-2], k
    if cols & (cols - 1) or rows & (rows - 1):
        raise ValueError(f"x's last two axes must be powers of two, got {tuple(x.shape)}")
    if scale is not None:
        s, s_con = scale
        if s.shape != (rows, cols) or s_con.shape != (rows, cols):
            raise ValueError(f"the scale tables must be ({rows}, {cols}), got "
                             f"{tuple(s.shape)} and {tuple(s_con.shape)}")
        if s.dtype != torch.int32 or s_con.dtype != torch.int32:
            raise TypeError("the scale tables must be int32")
    f_log = (cols if contract == "left" else rows).bit_length() - 1
    return k, k.bit_length() - 1, f_log


def limb_matmul_plain(mat_limbs: torch.Tensor, x: torch.Tensor, q: int, contract: str,
                      scale=None) -> torch.Tensor:
    """K11's plain version on x's device: (mat @ x) mod q through the same
    limbs, 16 limb products (float64 matrix products, exact), diagonals and
    recombination; then, with ``scale`` = (s, s_con), the strict product by
    the (N1, N2) table.  ``left``: x (b, K, F), out[b, j, i] = sum_k
    mat[j, k] x[b, k, i]; ``right``: x (..., N1, K), out[..., j] = sum_k
    x[..., k] mat[j, k].  int32 in and out; strict."""
    _check(mat_limbs, x, q, contract, scale)
    xl = _limbs_of_values(x)
    ml = mat_limbs.to(torch.float64)
    diags = [None] * (2 * LIMBS - 1)
    if contract == "left":
        free = x.shape[-1]
        xcat = torch.cat(xl, dim=-1).to(torch.float64)  # (b, K, 4F)
        parts = [torch.matmul(ml[s], xcat).split(free, dim=-1) for s in range(LIMBS)]
    else:
        free = x.shape[-2]
        xcat = torch.cat(xl, dim=-2).to(torch.float64)  # (..., 4 N1, K)
        parts = [torch.matmul(xcat, ml[s].T).split(free, dim=-2) for s in range(LIMBS)]
    for s in range(LIMBS):
        for t in range(LIMBS):
            d = s + t
            diags[d] = parts[s][t] if diags[d] is None else diags[d] + parts[s][t]
    out = _horner_mod_q([dg.to(torch.int32) for dg in diags], q)
    if scale is not None:
        out = mm.cond_sub32(mm.shoup_mul32_q2(scale[0], scale[1], out, q), q)
    return out.contiguous()


@trace.traced("kernel")
def limb_matmul(mat_limbs: torch.Tensor, x: torch.Tensor, q: int, contract: str,
                scale=None) -> torch.Tensor:
    """K11: ``limb_matmul_plain``'s function, launched on the card for a
    CUDA tensor (contiguous x, K <= 4096; the body ``body(K)``), its plain
    version for a CPU tensor."""
    if native.route(x) == "cpu":
        return limb_matmul_plain(mat_limbs, x, q, contract, scale)
    k, k_log, f_log = _check(mat_limbs, x, q, contract, scale)
    tensors = (mat_limbs, x) + (tuple(scale) if scale is not None else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"limb_matmul's operands lie on {sorted({str(t.device) for t in tensors})}")
    if k_log > MAX_K_LOG:
        raise ValueError(f"K11 takes K <= 2^{MAX_K_LOG}, got K = {k}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("limb_matmul takes contiguous tensors aligned to 16 bytes")
    out = torch.empty_like(x)
    batch = x.shape[0] if contract == "left" else x.numel() // k
    if batch == 0:
        return out
    name = f"limb_matmul_{contract}" + ("_scaled" if scale is not None else "")
    s_ptrs = (scale[0].data_ptr(), scale[1].data_ptr()) if scale is not None else (None, None)
    with torch.cuda.device(x.device):
        native.launch(name, mat_limbs.data_ptr(), x.data_ptr(), out.data_ptr(), *s_ptrs, q,
                      batch, k_log, f_log, native.stream(x.device))
    return out


def _split_view(a: torch.Tensor, n1_log: int) -> torch.Tensor:
    """(..., N) as (b, N1, N2)."""
    n = a.shape[-1]
    return a.reshape(-1, 1 << n1_log, n >> n1_log)


def fwd_mxu(a: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """Forward NTT of int32 words below q < 2^28 (..., N): K11 ``left`` by
    M1 with the twiddle T fused, then K11 ``right`` by W2; standard
    bit-reversed order, strict.  With ``plain`` the plain versions run
    wherever a lies."""
    fn = limb_matmul_plain if plain else limb_matmul
    tabs = plan.device_tables(a.device).mxu(inverse=False)
    col = fn(tabs["m1"], _split_view(a.contiguous(), tabs["n1_log"]), plan.q, "left",
             (tabs["t"], tabs["t_con"]))
    return fn(tabs["w2"], col, plan.q, "right").reshape(a.shape)


def inv_mxu(a: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """Inverse of ``fwd_mxu`` (bit-reversed in, natural out, strict): K11
    ``right`` by W2i with the scale S (N^-1 folded in) fused, then K11
    ``left`` by M1i."""
    fn = limb_matmul_plain if plain else limb_matmul
    tabs = plan.device_tables(a.device).mxu(inverse=True)
    col = fn(tabs["w2i"], _split_view(a.contiguous(), tabs["n1_log"]), plan.q, "right",
             (tabs["s"], tabs["s_con"]))
    return fn(tabs["m1i"], col, plan.q, "left").reshape(a.shape)


def tables_from_numpy(d: dict) -> dict:
    """The JAX package's mxu tables (``get_mxu_tables`` or
    ``get_mxu_inv_tables`` of ``ntt_tpu.kernels.mxu``, their arrays passed
    through ``np.asarray``) as the port's: limbs int8, the (N1, N2) tables
    uint64, ``n1_log`` an int, under the same keys (``NttPlan.from_numpy``
    takes them as ``"mxu"`` / ``"mxu_inv"``)."""
    out = {}
    for k, v in d.items():
        if k == "n1_log":
            out[k] = int(v)
        else:
            arr = np.asarray(v)
            out[k] = arr.astype(np.int8) if arr.dtype == np.int8 else arr.astype(np.uint64)
    return out
