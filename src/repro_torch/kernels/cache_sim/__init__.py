"""Occupancy-masked LRU stack-distance counting (CUDA kernel + plain torch)."""
