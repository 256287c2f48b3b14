"""Paged decode attention (CUDA kernel + plain torch)."""
