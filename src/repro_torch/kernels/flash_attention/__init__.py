"""Prefill attention (CUDA kernel + plain torch)."""
