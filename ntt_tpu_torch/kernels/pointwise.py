"""Element-wise (a * b) mod q: CUDA kernel K3 and its wrapper.

In the JAX package this step is XLA code (``api._jit_pointwise`` over
``modmath.mul_mod_q32`` / ``mul_mod_q``), which XLA fuses; as plain
PyTorch it would be some twenty passes over device memory, so on the card
it is a kernel (``csrc/pointwise.cu``).  It is bound by device memory:
three words move per element.  The plain version is ``modmath``'s.

The wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors, with no fallback between them; ``LAUNCHES`` counts the
kernel launches per width.

``solinas_mul`` is a check, on no transform path: ``csrc/modarith.cuh``'s
Solinas product alone, element-wise on operands of any value, against
``modmath.mul_mod_q2_solinas`` / ``mul_mod32_q2_solinas``;
``CHECK_LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native

LAUNCHES = {"mul_mod_u32": 0, "mul_mod_u64": 0}
CHECK_LAUNCHES = {"solinas_mul_u32": 0, "solinas_mul_u64": 0}


def mul_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a * b) mod q element-wise for reps a, b < q of one shape; strict."""
    u32 = mm.uses_u32(q)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if native.route(a) == "cpu":
        return mm.mul_mod_q32(a, b, q) if u32 else mm.mul_mod_q(a, b, q)
    dtype = mm.dtype_for(q)
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"expected {dtype} for q={q:#x}, got {a.dtype}, {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mul_mod takes contiguous tensors")
    if q >= 1 << 62:
        raise ValueError(f"q must be < 2^62, got a {q.bit_length()}-bit q")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    name = "mul_mod_u32" if u32 else "mul_mod_u64"
    with torch.cuda.device(a.device):
        native.launch(name, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), q,
                      native.stream(a.device))
    LAUNCHES[name] += 1
    return out


def solinas_mul(w: torch.Tensor, t: torch.Tensor, q: int) -> torch.Tensor:
    """The two-fold Solinas product of w and t element-wise at q = 2^e -
    2^k + 1, whatever the switch: word 64 on int64 tensors (``solinas_form``),
    word 32 on int32 ones (``solinas_form32``); w and t may hold any word,
    not only lazy values."""
    if w.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"expected int32 or int64, got {w.dtype}")
    word = 64 if w.dtype == torch.int64 else 32
    form = mm.solinas_form(q) if word == 64 else mm.solinas_form32(q)
    if form is None:
        raise ValueError(f"q={q:#x} is not of the word-{word} Solinas form")
    if w.device != t.device or w.dtype != t.dtype or w.shape != t.shape:
        raise ValueError("w and t differ in device, dtype or shape")
    if native.route(w) == "cpu":
        fold = mm.mul_mod_q2_solinas if word == 64 else mm.mul_mod32_q2_solinas
        return fold(w, t, q, *form)
    if not (w.is_contiguous() and t.is_contiguous()):
        raise ValueError("solinas_mul takes contiguous tensors")
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    name = f"solinas_mul_u{word}"
    with torch.cuda.device(w.device):
        native.launch(name, w.data_ptr(), t.data_ptr(), out.data_ptr(), w.numel(), *form,
                      native.stream(w.device))
    CHECK_LAUNCHES[name] += 1
    return out
