"""RO eviction-token replays (CUDA kernels + plain torch host loops)."""
