"""Element-wise (a * b) mod q: CUDA kernel K3 and its wrapper.

In the JAX package this step is XLA code (``api._jit_pointwise`` over
``modmath.mul_mod_q32`` / ``mul_mod_q``), which XLA fuses; as plain
PyTorch it would be some twenty passes over device memory, so on the card
it is a kernel (``csrc/pointwise.cu``).  It is bound by device memory:
three words move per element.  The plain version is ``modmath``'s.

The wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors, with no fallback between them; ``LAUNCHES`` counts the
kernel launches per width.
"""

from __future__ import annotations

import torch

from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch import native

LAUNCHES = {"mul_mod_u32": 0, "mul_mod_u64": 0}


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
