"""Tensor ops of the port, each beside its JAX counterpart in sd3_tpu/ops."""
