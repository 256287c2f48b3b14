"""Reuse-distance counting for the per-tenant Analyzer (CUDA kernel + plain torch)."""
