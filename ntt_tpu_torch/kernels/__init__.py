"""Transform kernels: plain PyTorch versions and CUDA kernel wrappers."""
