"""ntt_tpu_torch: the negacyclic NTT of ``ntt_tpu`` in PyTorch and CUDA.

The same transforms over R_q[X]/(X^N+1) as the JAX package, written for
one NVIDIA Hopper GPU: plain PyTorch functions on int32 / int64 tensors
(holding uint32 / uint64 bit patterns), and hand-written ``sm_90a`` CUDA
kernels (``csrc/``) for the hot path.  The JAX package stays the
reference this package is held against; this package imports neither jax
nor anything of ``ntt_tpu``, and keeps its own copy of the fixtures and
twiddle tables (``params``, ``twiddles``).
"""

from ntt_tpu_torch.params import FIXTURES, NttParams, bench_params  # noqa: F401

__version__ = "0.1.0"
