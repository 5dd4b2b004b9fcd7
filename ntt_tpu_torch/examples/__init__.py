"""Runnable examples of the port: ``python -m ntt_tpu_torch.examples.he_demo``."""
